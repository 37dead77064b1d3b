"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. prints the card's name and power limit (nvidia-smi), builds every
     CUDA kernel from the sources in the checkout (one nvcc per source,
     all started together) and prints the build time;
  2. holds each kernel against its plain PyTorch version on the card, on
     small cases:
       - K1 int8: both pass orders, C in {1, 2, 3, 4, 5, 8}, chunked and
         unchunked lane forms, ragged edges and the edges of the
         tensor-core tiling, each at every slice height its order takes
         (INT8_ROWS): bit-equal;
       - K1 split-bf16: both orders (vh also on upsizes of both axes),
         split2/split3 mode pairs, u8/u16/f32 in, f32/u8/u16 out with
         trunc_bits 0, 2 and 4, C in {1, 2, 3, 4, 5, 8}, chunked and unchunked
         lanes, the edges of the vh and hv kernels' tensor-core tiling
         (SPLIT_VH_EDGE_CASES, SPLIT_HV_EDGE_CASES) and precision="fast"
         to float32 in both orders (SPLIT_FAST_CASES): float32 within
         max|plain| * 1e-4, integers within 1 LSB (one quantization step
         when trunc_bits > 0);
       - K4 wavefront: C in {1, 2, 3, 4, 5, 8}, one and several row
         groups (one launch each), W = 1, 8- and 16-bit steps, both sum
         orders (the wavefront's and the sequential scan's): bit-equal;
       - K1's epilogue variants: round-half-even with LANCIR's scale, and
         sRGB gamma with the C=4 alpha bypass, in int8 vh/hv (bit-equal,
         at every slice height; the linearization read from the kernel's
         shared table, also at the edges of its tensor-core tiling) and split
         vh/hv (the split gate above; an integer output whose float32
         difference is amplified, by LANCIR's scale > 1 or by gamma-out,
         takes the float32 gate on its range plus one step);
       - K2, K3 (max * 1e-5; K3 also at the edges of its tensor-core
         tiling, K3_EDGE_CASES), K5 (bit-equal, on both load paths) and
         K1's limb-plane input (bit-equal; vh and hv on the tensor cores, hv at every slice
         height);
       - K6 ring: the JAX package's five ring cases plus C = 1 and
         clusters of 8, 12 and 16 blocks, bit-equal to its plain version
         and to K1's in-kernel gamma kernel;
       - K7 planar and K8 interleaved: C in {1, 3, 4}, split2/split3,
         u8/u16/f32 in, f32/u8/u16 out, trunc_bits 0 and 2, gamma with
         alpha, and the edges of their tensor-core tiling (Tv off the slice
         height, h_range segments that end inside a 128-pixel segment,
         windows and rows off 16 bytes, alpha planes that are not the
         last, a split2 second pass with float32 output): the split gate
         (with the flip term of a split2 second pass, _planar_tol);
  3. drives the main path through ``avir_tpu_torch.ImageResizer.resize``
     (and ``LancIR.resize``), with the launch counts set to 0 just before
     each first call and read just after:
       - 7680x4320 -> 1920x1080, 1920x1080 -> 3840x2160 and 640x480 ->
         1024x768 u8 RGB (K1 int8, one launch): bit-equal to the plain
         version, within 1 LSB / >= 60 dB of the float64 host oracle; the
         MACs the kernel issues beside the band MACs of its bound, the
         first pass's reads per input byte in this tiling and the one
         before, the kernel at every slice height it takes (bit-equal,
         timed beside slice_rows' choice in SWEEP_TURNS alternating
         turns), and the exact route (and at
         the downsize the split route) timed as yardsticks;
       - 8k_to_1080p_errdiff, 7680x4320 -> 1920x1080 u8 RGB with
         dither="errdiff" (K1 split2/split3 to a float32 pre-dither
         image, then one K4 launch): the pre-dither image within
         255 * 1e-4 of the oracle's, K4 bit-equal to its plain version in
         10 runs and at every swept row-group size, the output within
         1 LSB of the oracle's serial error diffusion;
       - 1080p_to_4k_errdiff, 1920x1080 -> 3840x2160 u8 RGB with
         dither="errdiff" (K1 split hv, split2 first pass / split3 second,
         as choose_fused's rule 4 orders a u8 upsize of 8 M output values
         or more, then one K4 launch): the gates of 8k_to_1080p_errdiff
         (the oracle's error diffusion on the output's top
         ERRDIFF_ORACLE_ELEMS elements); K1 split vh on the same resize
         timed beside it by a direct call;
       - 1080p_to_4k_u16, 1920x1080 -> 3840x2160 u16 RGB,
         res_bit_depth=16 (K1 split3/split3 vh, as the JAX package's
         choose_fused orders a 2-byte upsize): within 1 LSB of the plain
         version, within 4 LSB / >= 60 dB of the oracle; the hv order
         checked and timed beside it by a direct call;
       - lancir_8k_to_1080p, ``LancIR.resize`` 7680x4320 -> 1920x1080 u8
         RGB (K1 int8 vh, round-half-even): bit-equal to the plain
         version, within 1 LSB / >= 60 dB of ``execute_lancir_numpy``;
       - lancir_4k_u16_to_1080p_u8, 3840x2160 u16 RGB -> 1920x1080 u8 (K1
         split3/split3 vh, scale 255/65535, round-half-even): within 1 LSB
         of the plain version and 1 LSB / >= 60 dB of the oracle;
       - 8k_to_1080p_gamma, ``ImageResizer.resize(use_srgb_gamma=True)``
         7680x4320 -> 1920x1080 u8 RGB with AVIR_TPU_GAMMA_ROUTE=inkernel
         (K1 int8 vh on the s8 tensor cores with the 13-bit linearization
         from its table): bit-equal to the plain version, within 1 LSB /
         >= 60 dB of the float64 gamma oracle, its bound, the MACs it
         issues against the band's and its stagings per input element;
         the "auto" route (the same kernel) timed beside it, bit-equal;
       - 4k_to_8k_u16_gamma_rgba, 3840x2160 -> 7680x4320 u16 RGBA,
         ``alpha_index=3``, ``res_bit_depth=16``, the benchmark's 16-bit
         cell (K1 split3/split3 vh with the degree-9 linearization): within
         the split gate of the plain version and 16 LSB / >= 60 dB of the
         oracle (the cell's ``excess_lsb`` limit); hv beside it, as above;
       - 1080p_to_4k_u16_gamma_rgba, 1920x1080 -> 3840x2160, the same
         keywords and kernel: within the split gate of the plain
         version and 5 LSB / >= 60 dB of the oracle (the JAX package's
         gate for its fused u16 gamma route); hv beside it, as above;
       - 1080p_to_4k_gamma, 1920x1080 -> 3840x2160 u8 RGB with sRGB gamma
         (K1 int8 hv gamma, the in-kernel route on the s8 tensor cores):
         bit-equal to the plain version, within 2 LSB / >= 60 dB of the
         float64 gamma oracle (13-bit linear light through the sRGB slope),
         its counts as at 8k_to_1080p_gamma, every slice height (bit-equal,
         timed in turns) and ptxas's registers and spills of fused_int8;
       - 640x480_gamma_down, 1000x700 -> 640x480 u8 RGB with sRGB gamma on
         the default route ("auto": K1 int8 vh with the in-kernel gamma;
         K6 cannot take a downsize without a uniform row stride): the
         gates and counts of 1080p_to_4k_gamma;
       - the unfused shapes (K4 checked as at 8k_to_1080p_errdiff; K3 with
         its bound, its load path, the MACs its MMAs issue against the band
         MACs and ptxas's registers and spills; K2 with its MACs and
         ptxas's; K2 exact, which no resize runs, on K3's float32 output at
         the first two and, at the first, on the u8 image, split2 beside
         it and bit-equal, and on the image as u16: max|plain| * 1e-5,
         each with its bound, the term that decides it and its MACs), the
         prologue shapes (K5 with its bound, its load path and ptxas's
         registers and spills, bit-equal; 8k_to_1080p_gamma_prologue, K1's
         limb-plane vh on the tensor cores; 1080p_to_4k_gamma_prologue,
         its hv, also at every slice height: bit-equal, timed in
         alternating turns), then
         the ring route at 8k_to_1080p_gamma_ring and
         4k_to_720p_gamma_ring (one K6 launch with
         AVIR_TPU_GAMMA_ROUTE=ring; bit-equal to its plain version and
         to the "auto", in-kernel and prologue routes; the cluster size,
         the linearizations per input element, the shared memory a block,
         the clusters the card holds at once, ptxas's registers and spills
         and a sweep of the row parts), and K7/K8 called
         directly (no resize routes to them) at 8k_to_1080p_planar (u8
         RGB split2/split3) and
         1080p_to_4k_u16_gamma_rgba_planar (split3/split3, gamma, alpha
         3): the split gate of their plain versions, ptxas's registers and
         spills, the MACs the MMAs issue beside the band MACs, the image
         elements staged per input element and K8's design;
  3b. drives the rest of the single-card public API, each phase with the
     launch counts set to 0 just before it and read just after:
       - batch_1080p_to_4k, batch_8k_to_1080p (with LancIR.resize_batch of
         2 frames) and batch_1080p_to_4k_u16_out (into a caller's reused
         ``out=``): ``ImageResizer.resize_batch`` of 8 / 4 / 4 frames
         through pinned staging, each frame bit-equal to ``resize`` of it,
         K1 launched once per frame; the wall per frame beside the single
         resize's, the per-frame copies through pinned buffers beside the
         pageable ones, and the batch's device trace (torch.profiler: busy
         and idle share, gaps between the frames' kernels);
       - device_fn_8k_to_1080p: ``make_resize_fn`` on a CUDA tensor, one
         K1 launch, a CUDA tensor out, bit-equal to ``resize``; device ms
         per call beside the kernel's;
       - errdiff_device_720p_to_1080p: ``dither="errdiff-device"``, one K4
         launch in the sequential scan's sum order, bit-equal to its plain
         version on the same pre-dither image, beside ``dither="errdiff"``
         (the wavefront's order) and the pixels where the two differ;
       - cli_1080p_to_4k: ``python -m avir_tpu_torch.cli``'s ``main`` on a
         PNG written by the native binding, on the card (the phase fails if
         the binding does not load), the output PNG decoding to
         ``resize``'s bits;
  3c. drives the row-strip mesh (``avir_tpu_torch.parallel``, MESH_CASES):
     world A, four gloo processes time-sharing the one card
     (``torch.multiprocessing.spawn``, a free port, a rendezvous timeout,
     a join limit): 8K -> 1080p over sp 4 (K1 int8 vh per rank), 4 frames
     of 1080p -> 4K over dp 2 x sp 2 (int8 vh per strip), 720p -> 1080p
     errdiff over sp 4 (K1 split vh, one all-gather, K4 on every rank),
     LANCIR 8K -> 1080p (int8 vh even), 640x16 -> 320x5 (the all-gather
     fallback on ``torch.bmm``) and 8K -> 1080p with ``halo_overlap``
     (border, interior and border launches, bit-equal to the first case);
     then world B, NCCL with one process on 8K -> 1080p, and with
     min(cards, 4) processes where there are two cards or more.  Every
     rank sets the launch counts to 0 just before its executor call and
     reads them just after, holds each K1 launch of its strip to the plain
     version (int8 bit-equal, split within the split gate), and prints its
     strip kernel ms, halo ms and bytes and gather ms and bytes; rank 0
     holds the assembled image within 1 LSB of the single-card ``resize``
     (with the count of differing pixels) and, at 8K, within 1 LSB and
     >= 60 dB of the float64 oracle.  A worker's failure fails the script.
     Then the per-launch overhead of K1 and the scaling model's table
     (``parallel/scaling_model.py``: data-sheet links, this run's K1 time;
     a model, not a measurement);
  3d. drives the 2-D (rows x cols) mesh (MESH2D_CASES): world A again,
     four gloo processes on the one card: 8K -> 1080p on 1 x 4 tiles
     (``suggest_grid``'s choice at n = 4) and on 2 x 2, also with
     ``halo_overlap`` (three launches, bit-equal to 2 x 2), LANCIR 8K ->
     1080p on 2 x 2 (int8 vh even), 720p -> 1080p errdiff on 2 x 2 (K1
     split vh, a gather over cp then sp, K4 on every rank), 70x90 ->
     50x62 gamma RGBA (the alpha bypass on odd tiles) and u8 RGB on 1 x 4
     (tiles whose lanes are no multiple of 16); then NCCL with one process
     on 8K as one tile.  Every rank sets the launch counts to 0 just
     before its executor call and reads them just after, holds each K1
     launch of its tile body to the plain version on its own tiles, and
     prints its K1 ms a tile, column- and row-halo ms and bytes, the
     gather's, and each launch's input width and load path; rank 0 checks
     the assembled image as in 3c.  Then every rank's ``Tile.compute``
     alone on the card at 8K on the 1x2, 1x4, 2x2 and 4x1 grids (tiles
     cut from the padded image; the assembled tiles must give the single
     card's bits), whose slowest rank is the 2-D scaling model's compute
     term, printed beside the 1-D table;
  4. times each kernel at its main-path shape with CUDA events (L2
     flushed before every launch) beside its bound and its plain
     version's time, plus the host wall time of a cached resize and its
     two copies (and, for the shapes of the split and epilogue variants,
     the ``precision="exact"`` route as a yardstick), sweeps K4's row
     groups (K4_GROUP_WARPS, with the instantiation each runs, and the
     default groups' in ``k4_forms``) at the errdiff cells, and prints one
     JSON line per shape; at the K1 split cells (and their direct calls
     in the other pass order) that line also holds the dense MACs the
     kernel issues beside the band MACs of its bound, and the image
     elements its first pass stages per input element, in the kernel's
     tiling and in the tiling before it (hv: the fmaf kernel's 32-row
     slices);
  5. prints the kernels line (every kernel of KERNELS, one entry each at
     its first main-path shape) and, last, the device line.

``python3 chip_smoke.py --kernel-times DIR`` times K1 int8 without gamma
(vh, vh even, hv) at its four main-path cells, K6 at
8k_to_1080p_gamma_ring and 4k_to_720p_gamma_ring ("ring"), K5 and K1
int8 from its limb planes at 8k_to_1080p_gamma_prologue (vh) and
1080p_to_4k_gamma_prologue (hv), K1 int8 with the in-kernel gamma at
8k_to_1080p_gamma ("inkernel"), 1080p_to_4k_gamma and 640x480_gamma_down
(both "auto"; with their bounds, MACs, stagings and, for hv, every slice
height), K2 split3 at 720p_to_1080p_errdiff and
1080p_to_4k_gamma_errdiff (KT_K2_CELLS), K2 exact on the same
inputs (and at the first cell on the u8 image, split2 beside it, and on
the image as u16), K3 at those two and
lancir_720p_to_1080p_f32 (KT_K3_CELLS), K7 and K8 at the two planar
shapes (KT_PLANAR_CELLS, with K1 split of the same resize beside them) and
K1 split hv at 1080p_to_4k_errdiff and, with gamma,
1080p_to_4k_u16_gamma_rgba and 4k_to_8k_u16_gamma_rgba (KT_SPLIT_HV_CELLS,
K1 split vh of the same resize beside them) on the package under DIR instead (one JSON line, with
output hashes, K1 split hv's, K3's, K5's, K7's and K8's bounds, ptxas's
registers and spills of the fused_int8, planar, fused_split and banded
libraries and, at the two int8 downsizes, the split route beside it), so
that two versions of
the kernels can be compared in turns within one chip call.
``python3 split_hv_heights.py`` times K1 split hv at 32, 64 and 128 rows
a block at KT_SPLIT_HV_CELLS.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data sheet (700 W): HBM rate, dense int8 and bf16 tensor-core
# rates, and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
BF16_OPS_PER_S = 0.989e15
F32_OPS_PER_S = 67e12
# Float32 operations of K1's gamma stages (k1_common.cuh), per input
# element as staged once (int8: scale + 7 FMA; split: scale + 9 FMA) and
# per output element (3 square roots + 6 FMA + the output multiply).
GAMMA_IN_OPS = {"int8": 15, "split": 19}
GAMMA_OUT_OPS = 16
SEED = 7
MAIN_PATH = (
    # (name, src_w, src_h, new_w, new_h, c)
    ("8k_to_1080p", 7680, 4320, 1920, 1080, 3),
    ("1080p_to_4k", 1920, 1080, 3840, 2160, 3),
    # __graft_entry__.py's configuration.
    ("640x480_to_1024x768", 640, 480, 1024, 768, 3),
)
KERNEL_CASES = (
    # (src_w, src_h, new_w, new_h, c, lane tile, order)
    (150, 90, 61, 37, 1, None, "vh"),
    (200, 150, 80, 60, 3, None, "vh"),
    (181, 77, 60, 33, 4, None, "vh"),
    (120, 80, 70, 50, 3, 50, "vh"),
    (45, 31, 97, 70, 1, None, "hv"),
    (2000, 12, 4100, 25, 1, None, "hv"),
    (300, 20, 1400, 41, 3, None, "hv"),
    (500, 20, 1200, 41, 4, None, "hv"),
    (29, 21, 71, 45, 4, 48, "hv"),
    (96, 80, 70, 101, 3, None, "vh"),
    (96, 80, 70, 101, 3, None, "hv"),
    (1031, 517, 263, 129, 3, None, "vh"),
    (333, 251, 1001, 777, 3, None, "hv"),
    # The edges of the tensor-core kernels' tiling, tests/torch_cases.py's
    # edge_* cases: rows_out not a multiple of any slice height, C = 2, a
    # downsize by more than 4, odd lanes_in, an hv at 128-row slices with a
    # ragged last slice, an hv slice range above 256 rows (windows).
    (300, 250, 170, 150, 3, None, "vh"),
    (97, 83, 61, 45, 2, None, "vh"),
    (1031, 517, 200, 97, 3, None, "vh"),
    (45, 31, 97, 70, 3, None, "hv"),
    (53, 37, 90, 71, 2, None, "hv"),
    (150, 100, 400, 300, 3, None, "hv"),
    (20, 1200, 500, 50, 1, None, "hv"),
    # More than 4 channels.
    (90, 60, 40, 27, 5, None, "vh"),
    (30, 20, 61, 47, 8, None, "hv"),
)
# Slice heights each K1 int8 case also runs at (fused_kernel.py:at_rows),
# whatever slice_rows picks: vh takes 32, hv also 64 and 128.
INT8_ROWS = {"vh": (32,), "hv": (32, 64, 128)}
# Turns of the slice-height sweep at the main-path cells: each turn times
# every height once (20 launches each), so that the heights alternate.
SWEEP_TURNS = 5
SPLIT_CASES = (
    # (src_w, src_h, new_w, new_h, c, lane tile, order, mode_v, mode_h,
    #  in type, out type, trunc_bits)
    (200, 150, 80, 60, 3, None, "vh", "split2", "split3", "u8", "f32", 0),
    (150, 90, 61, 37, 1, None, "vh", "split2", "split3", "u8", "u8", 0),
    (181, 77, 60, 33, 4, None, "vh", "split3", "split3", "u16", "u16", 4),
    (120, 80, 70, 50, 3, 50, "vh", "split3", "split3", "f32", "u8", 2),
    (200, 150, 80, 60, 3, None, "vh", "split2", "split2", "u8", "u8", 0),
    (45, 31, 97, 70, 1, None, "hv", "split3", "split3", "u16", "u16", 0),
    (300, 20, 1400, 41, 3, None, "hv", "split3", "split2", "u8", "f32", 0),
    (29, 21, 71, 45, 4, 48, "hv", "split3", "split3", "f32", "f32", 0),
    (40, 30, 64, 48, 3, None, "hv", "split2", "split2", "u8", "u16", 2),
    (500, 20, 1200, 41, 4, None, "hv", "split3", "split3", "u16", "u8", 0),
    (96, 80, 70, 101, 3, None, "vh", "split3", "split3", "u16", "f32", 0),
    (96, 80, 70, 101, 1, None, "hv", "split3", "split2", "u8", "u8", 4),
    (1031, 517, 263, 129, 3, None, "vh", "split2", "split3", "u8", "f32", 0),
    (333, 251, 1001, 777, 3, None, "hv", "split3", "split3", "u16", "u16", 0),
    (90, 60, 40, 27, 5, None, "vh", "split3", "split3", "u16", "u16", 0),
    (30, 20, 61, 47, 8, None, "hv", "split2", "split3", "u8", "f32", 0),
)
WAVEFRONT_CASES = (
    # (h, w, c, trunc_bits, out_max, block_rows)
    (24, 40, 1, 0, 255.0, None),
    (20, 33, 3, 0, 255.0, None),
    (17, 29, 4, 0, 255.0, None),
    (90, 70, 3, 0, 255.0, 16),
    (200, 130, 4, 0, 65535.0, None),
    (700, 300, 1, 0, 255.0, None),
    (18, 27, 4, 4, 65535.0, None),
    (77, 64, 3, 4, 65535.0, 10),
    (22, 30, 3, 2, 255.0, 7),
    (16, 21, 5, 0, 255.0, None),
    (14, 19, 8, 2, 255.0, None),
)
NEW_SHAPES = (
    # (name, src_w, src_h, new_w, new_h, c, in dtype, res_bit_depth, dither)
    ("8k_to_1080p_errdiff", 7680, 4320, 1920, 1080, 3, np.uint8, 8, "errdiff"),
    # Upscaling 8-bit HD frames to UHD with error diffusion: K1 split hv
    # (choose_fused rule 4); its image comes from a generator of its own
    # (seed SEED), so that the cells after it keep their inputs.
    ("1080p_to_4k_errdiff", 1920, 1080, 3840, 2160, 3, np.uint8, 8, "errdiff"),
    ("1080p_to_4k_u16", 1920, 1080, 3840, 2160, 3, np.uint16, 16, "default"),
)
KERNELS = {
    "fused_int8_vh": "avir_tpu/ops/pallas/fused_kernel.py:191 (_int8_passes, "
    "order vh; entry apply_fused_pallas :422)",
    "fused_int8_hv": "avir_tpu/ops/pallas/fused_kernel.py:268 (_int8_passes, "
    "order hv; entry apply_fused_pallas :422)",
    "fused_split_vh": "avir_tpu/ops/pallas/fused_kernel.py:344 (_kernel float "
    "branch, order vh; _rmul :130, _finish :400; entry apply_fused_pallas :422)",
    "fused_split_hv": "avir_tpu/ops/pallas/fused_kernel.py:362 (_kernel float "
    "branch, order hv; _rmul :130, _finish :400; entry apply_fused_pallas :422)",
    "wavefront": "avir_tpu/ops/pallas/wavefront_kernel.py:229 "
    "(wavefront_scan_pallas_carry, _kernel_carry :139) and :331 "
    "(wavefront_scan_pallas, _kernel :55)",
    "fused_int8_vh_even": "avir_tpu/ops/pallas/fused_kernel.py:191 "
    "(_int8_passes, order vh) with _finish :400-419 (scale, "
    "round_mode='even'); entry apply_fused_pallas :422",
    "fused_int8_vh_gamma": "avir_tpu/ops/pallas/fused_kernel.py:210-244 "
    "(_int8_passes gamma first pass, _srgb_to_linear13_u8poly :117), "
    ":323-327 (_linear_to_srgb :79), _finish :400; entry "
    "apply_fused_pallas :422",
    "fused_int8_hv_gamma": "avir_tpu/ops/pallas/fused_kernel.py:268-279 "
    "(_int8_passes order hv, gamma first pass; _srgb_to_linear13_u8poly "
    ":117), :323-327 (_linear_to_srgb :79), _finish :400; entry "
    "apply_fused_pallas :422",
    "fused_split_vh_gamma": "avir_tpu/ops/pallas/fused_kernel.py:338-342 "
    "(pack, _srgb_to_linear :69), :344-361 (order vh), :388-392 (unpack, "
    "_linear_to_srgb :79), _finish :400; entry apply_fused_pallas :422",
    "fused_split_vh_even": "avir_tpu/ops/pallas/fused_kernel.py:344-361 "
    "(_kernel float branch, order vh) with _finish :400-419 (scale, "
    "round_mode='even'); entry apply_fused_pallas :422",
    "fused_split_hv_gamma": "avir_tpu/ops/pallas/fused_kernel.py:338-342 "
    "(pack, _srgb_to_linear :69), :362-386 (order hv), :388-392 (unpack, "
    "_linear_to_srgb :79), _finish :400; entry apply_fused_pallas :422",
    "lanes_split2": "avir_tpu/ops/pallas/lanes_kernel.py:41 "
    "(apply_lanes_pallas, _kernel :24, mode split2)",
    "lanes_split3": "avir_tpu/ops/pallas/lanes_kernel.py:41 "
    "(apply_lanes_pallas, _kernel :24-38, mode split3)",
    "banded_split2": "avir_tpu/ops/pallas/banded_kernel.py:58 "
    "(apply_blocked_pallas, _kernel :37, mode split2)",
    "banded_split3": "avir_tpu/ops/pallas/banded_kernel.py:58 "
    "(apply_blocked_pallas, _kernel :37-46, mode split3)",
    "banded_exact": "avir_tpu/ops/pallas/banded_kernel.py:58 "
    "(apply_blocked_pallas, _kernel :47-54, mode exact)",
    "gamma_prologue": "avir_tpu/ops/pallas/gamma_prologue.py:48 "
    "(apply_gamma_prologue, _kernel :37)",
    "fused_int8_vh_gamma_pre": "avir_tpu/ops/pallas/fused_kernel.py:462-516 "
    "(x_lo limb-plane input, gamma_pre) with _int8_passes :191 and "
    "_linear_to_srgb :79; entry apply_fused_pallas :422",
    "fused_int8_hv_gamma_pre": "avir_tpu/ops/pallas/fused_kernel.py:462-516 "
    "(x_lo limb-plane input, gamma_pre) with _int8_passes order hv :268 and "
    "_linear_to_srgb :79; entry apply_fused_pallas :422",
    "fused_ring_vh_gamma": "avir_tpu/ops/pallas/fused_ring_kernel.py:137 "
    "(apply_fused_ring_pallas, _kernel :87)",
    "planar": "avir_tpu/ops/pallas/planar_kernel.py:117 (apply_planar_pallas, "
    "_kernel :41)",
    "planar2": "avir_tpu/ops/pallas/planar2_kernel.py:123 (apply_planar2_pallas, "
    "_kernel :54)",
}
SOURCES = {
    "fused_int8_vh": "avir_tpu_torch/ops/cuda/csrc/fused_int8.cu",
    "fused_int8_hv": "avir_tpu_torch/ops/cuda/csrc/fused_int8.cu",
    "fused_split_vh": "avir_tpu_torch/ops/cuda/csrc/fused_split.cu",
    "fused_split_hv": "avir_tpu_torch/ops/cuda/csrc/fused_split.cu",
    "wavefront": "avir_tpu_torch/ops/cuda/csrc/wavefront.cu",
    "fused_int8_vh_even": "avir_tpu_torch/ops/cuda/csrc/fused_int8.cu",
    "fused_int8_vh_gamma": "avir_tpu_torch/ops/cuda/csrc/fused_int8.cu",
    "fused_int8_hv_gamma": "avir_tpu_torch/ops/cuda/csrc/fused_int8.cu",
    "fused_split_vh_even": "avir_tpu_torch/ops/cuda/csrc/fused_split.cu",
    "fused_split_vh_gamma": "avir_tpu_torch/ops/cuda/csrc/fused_split.cu",
    "fused_split_hv_gamma": "avir_tpu_torch/ops/cuda/csrc/fused_split.cu",
    "lanes_split2": "avir_tpu_torch/ops/cuda/csrc/lanes.cu",
    "lanes_split3": "avir_tpu_torch/ops/cuda/csrc/lanes.cu",
    "banded_split2": "avir_tpu_torch/ops/cuda/csrc/banded.cu",
    "banded_split3": "avir_tpu_torch/ops/cuda/csrc/banded.cu",
    "banded_exact": "avir_tpu_torch/ops/cuda/csrc/banded.cu",
    "gamma_prologue": "avir_tpu_torch/ops/cuda/csrc/gamma_prologue.cu",
    "fused_int8_vh_gamma_pre": "avir_tpu_torch/ops/cuda/csrc/fused_int8.cu",
    "fused_int8_hv_gamma_pre": "avir_tpu_torch/ops/cuda/csrc/fused_int8.cu",
    "fused_ring_vh_gamma": "avir_tpu_torch/ops/cuda/csrc/fused_ring.cu",
    "planar": "avir_tpu_torch/ops/cuda/csrc/planar.cu",
    "planar2": "avir_tpu_torch/ops/cuda/csrc/planar.cu",
}
INT8_EPI_CASES = (
    # (src_w, src_h, new_w, new_h, c, lane tile, order, round_mode, scale,
    #  gamma, alpha_index)
    (150, 90, 61, 37, 1, None, "vh", "even", 1.0, False, -1),
    (200, 150, 80, 60, 3, None, "vh", "even", 1.0, False, -1),
    (181, 77, 60, 33, 4, None, "vh", "even", 0.75, False, -1),
    (120, 80, 70, 50, 3, 50, "vh", "even", 1.0, False, -1),
    (45, 31, 97, 70, 1, None, "hv", "even", 1.0, False, -1),
    (300, 20, 1400, 41, 3, None, "hv", "even", 1.0, False, -1),
    (29, 21, 71, 45, 4, 48, "hv", "even", 1.0, False, -1),
    (200, 150, 80, 60, 3, None, "vh", "biased", 1.0, True, -1),
    (181, 77, 60, 33, 4, None, "vh", "biased", 1.0, True, 3),
    (120, 80, 70, 50, 4, 50, "vh", "biased", 1.0, True, 0),
    (300, 20, 1400, 41, 3, None, "hv", "biased", 1.0, True, -1),
    (500, 20, 1200, 41, 4, None, "hv", "biased", 1.0, True, 3),
    (29, 21, 71, 45, 4, 48, "hv", "biased", 1.0, True, 3),
    (1031, 517, 263, 129, 4, None, "vh", "biased", 1.0, True, 3),
    (333, 251, 1001, 777, 4, None, "hv", "biased", 1.0, True, 3),
    (1031, 517, 263, 129, 3, None, "vh", "even", 1.0, False, -1),
    (300, 250, 170, 150, 3, None, "vh", "even", 0.75, False, -1),
    (150, 100, 400, 300, 3, None, "hv", "even", 0.75, False, -1),
    # The edges of the in-kernel gamma's tensor-core tiling
    # (tests/torch_cases.py's gamma_edge_*, gamma_odd_*, gamma_up_c4a0,
    # gamma_hv_windows_c1): rows_out off every slice height in both orders,
    # odd lanes_in in both orders, the alpha lane first in hv, hv windows.
    (300, 250, 170, 150, 3, None, "vh", "biased", 1.0, True, -1),
    (150, 100, 400, 300, 3, None, "hv", "biased", 1.0, True, -1),
    (97, 83, 61, 45, 3, None, "vh", "biased", 1.0, True, -1),
    (45, 31, 97, 70, 3, None, "hv", "biased", 1.0, True, -1),
    (53, 37, 90, 71, 4, None, "hv", "biased", 1.0, True, 0),
    (20, 1200, 500, 50, 1, None, "hv", "biased", 1.0, True, -1),
)
SPLIT_EPI_CASES = (
    # SPLIT_CASES' fields plus round_mode, scale, gamma, alpha_index
    (181, 77, 60, 33, 3, None, "vh", "split3", "split3", "u16", "u8", 0, "even", 255.0 / 65535.0, False, -1),
    (40, 30, 64, 48, 4, None, "hv", "split3", "split2", "u8", "u16", 0, "even", 65535.0 / 255.0, False, -1),
    (120, 80, 70, 50, 3, 50, "vh", "split3", "split3", "f32", "f32", 0, "even", 0.5, False, -1),
    (300, 20, 1400, 41, 3, None, "hv", "split2", "split2", "u8", "u8", 0, "even", 1.0, False, -1),
    (200, 150, 80, 60, 3, None, "vh", "split3", "split3", "u8", "u8", 0, "biased", 1.0, True, -1),
    (181, 77, 60, 33, 4, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 3),
    (150, 90, 61, 37, 1, None, "vh", "split3", "split3", "u8", "f32", 0, "biased", 1.0, True, -1),
    (45, 31, 97, 70, 4, None, "hv", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 3),
    (29, 21, 71, 45, 4, 48, "hv", "split3", "split3", "u8", "f32", 0, "biased", 1.0, True, 0),
    (300, 20, 1400, 41, 3, None, "hv", "split3", "split3", "f32", "u8", 2, "biased", 1.0, True, -1),
    (333, 251, 1001, 777, 4, None, "hv", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 3),
    (1031, 517, 263, 129, 3, None, "vh", "split3", "split3", "u16", "u8", 0, "even", 255.0 / 65535.0, False, -1),
)
# The cases below draw their inputs from a generator of their own (seed
# SEED + 1), so that every case above keeps its inputs.
# K1 split vh on 2- and 4-byte upsizes of both axes (the order
# runtime.choose_fused gives them), with and without gamma: SPLIT_EPI_CASES'
# fields.
SPLIT_VH_UP_CASES = (
    (45, 31, 97, 70, 3, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, False, -1),
    (40, 30, 64, 48, 1, None, "vh", "split3", "split3", "f32", "f32", 0, "biased", 1.0, False, -1),
    (53, 37, 90, 71, 2, None, "vh", "split3", "split3", "f32", "u16", 0, "biased", 1.0, False, -1),
    (29, 21, 71, 45, 4, 48, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, False, -1),
    (333, 251, 1001, 777, 4, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, False, -1),
    (45, 31, 97, 70, 4, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 3),
    (40, 30, 64, 48, 3, None, "vh", "split3", "split3", "f32", "f32", 0, "biased", 1.0, True, -1),
    (53, 37, 90, 71, 1, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, -1),
    (333, 251, 1001, 777, 4, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 3),
)
# The edges of K1 split vh's tensor-core tiling (64-row slices, lane
# segments in steps of 32, 16-deep MMA steps), tests/torch_cases.py's
# vh_edge cases: rows_out not a multiple of 64, nonzero V-tap ranges and
# lane windows ending inside an MMA step, C = 2, trunc_bits=4 into u16, a
# downsize by more than 4, lanes_in not a multiple of 4, u16 gamma with
# the alpha lane first.  SPLIT_EPI_CASES' fields; inputs from a generator
# of their own (seed SEED + 2).
SPLIT_VH_EDGE_CASES = (
    (300, 250, 170, 150, 3, None, "vh", "split2", "split3", "u8", "f32", 0, "biased", 1.0, False, -1),
    (97, 83, 61, 45, 2, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, False, -1),
    (150, 120, 90, 70, 3, None, "vh", "split3", "split3", "u16", "u16", 4, "biased", 1.0, False, -1),
    (1031, 517, 200, 97, 3, None, "vh", "split2", "split3", "u8", "u8", 0, "biased", 1.0, False, -1),
    (45, 31, 97, 70, 2, None, "vh", "split3", "split3", "f32", "f32", 0, "biased", 1.0, False, -1),
    (181, 77, 60, 33, 4, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 0),
    (53, 37, 90, 71, 4, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 0),
)
# The edges of K1 split hv's tensor-core tiling (64-row slices, 32-row
# groups, 32 window lanes a first-pass step, 16-deep MMA steps),
# tests/torch_cases.py's SPLIT_HV_EDGE_CASES: rows_out not a multiple of
# 64, nonzero V-tap ranges and lane windows ending inside an MMA step, C =
# 2, 5 and 8, lanes_in not a multiple of 4, a V-tap range many groups
# tall, gamma with the alpha lane first and last, trunc_bits=4 into u16.
# SPLIT_EPI_CASES' fields; inputs from a generator of their own (seed
# SEED + 4).
SPLIT_HV_EDGE_CASES = (
    (150, 100, 400, 300, 3, None, "hv", "split3", "split2", "u8", "f32", 0, "biased", 1.0, False, -1),
    (53, 37, 90, 71, 2, None, "hv", "split3", "split3", "u16", "u16", 0, "biased", 1.0, False, -1),
    (33, 21, 70, 45, 5, None, "hv", "split3", "split2", "u8", "u8", 0, "biased", 1.0, False, -1),
    (30, 20, 61, 47, 8, None, "hv", "split3", "split3", "f32", "f32", 0, "biased", 1.0, False, -1),
    (40, 30, 97, 70, 3, None, "hv", "split3", "split3", "u16", "u16", 4, "biased", 1.0, False, -1),
    (20, 1200, 500, 50, 1, None, "hv", "split3", "split2", "u8", "u8", 0, "biased", 1.0, False, -1),
    (45, 31, 97, 70, 4, None, "hv", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 0),
    (53, 37, 90, 71, 4, None, "hv", "split3", "split3", "u8", "u8", 0, "biased", 1.0, True, 3),
)
# precision="fast" to float32 output, vh and hv (tests/torch_cases.py's
# *_u8_f32_fast SPLIT_CASES): a split2 second pass, whose intermediate hi
# parts two summation orders can round one bf16 ulp apart.
# SPLIT_EPI_CASES' fields; inputs from a generator of their own (seed
# SEED + 5).
SPLIT_FAST_CASES = (
    (200, 150, 80, 60, 3, None, "vh", "split2", "split2", "u8", "f32", 0, "biased", 1.0, False, -1),
    (80, 60, 200, 150, 3, None, "hv", "split2", "split2", "u8", "f32", 0, "biased", 1.0, False, -1),
)
# K4 with row groups running at once: (h, w, c, trunc_bits, out_max, rows
# per group), one launch each.
K4_GROUP_CASES = (
    (700, 20, 3, 0, 255.0, 10),
    (300, 24, 4, 4, 65535.0, 8),
    (47, 1, 2, 0, 255.0, 16),
    (90, 31, 3, 0, 65535.0, 42),
    (700, 17, 3, 0, 255.0, 341),
)
EPI_SHAPES = (
    # (name, entry point, src_w, src_h, new_w, new_h, c, in dtype,
    #  out dtype, resize keywords, kernel variant, LSB gate vs the oracle,
    #  AVIR_TPU_GAMMA_ROUTE for the resize (None: unset), the variant of
    #  the other pass order timed beside it by a direct call (or None))
    ("lancir_8k_to_1080p", "lancir", 7680, 4320, 1920, 1080, 3, np.uint8,
     np.uint8, {}, "fused_int8_vh_even", 1, None, None),
    ("lancir_4k_u16_to_1080p_u8", "lancir", 3840, 2160, 1920, 1080, 3,
     np.uint16, np.uint8, {}, "fused_split_vh_even", 1, None, None),
    # In-kernel K1, named; "auto" (the variable unset) is timed beside it
    # and takes the same route.
    ("8k_to_1080p_gamma", "avir", 7680, 4320, 1920, 1080, 3, np.uint8,
     np.uint8, {"use_srgb_gamma": True}, "fused_int8_vh_gamma", 1, "inkernel",
     None),
    # The benchmark's 16-bit RGBA flagship (avir_def_u16_rgba_srgb's cell,
    # 15,360 input and 30,720 output lanes), before 1080p_to_4k_u16_gamma_rgba
    # so that the kernels line holds K1 split vh gamma (and hv gamma) at the
    # size the cell runs.  Oracle gate: the cell's excess_lsb limit, 16 (the
    # port reads up to ~6 LSB from the float64 reference over a whole 8K
    # frame, beyond 1080p's 5).
    ("4k_to_8k_u16_gamma_rgba", "avir", 3840, 2160, 7680, 4320, 4,
     np.uint16, np.uint16,
     {"use_srgb_gamma": True, "alpha_index": 3, "res_bit_depth": 16},
     "fused_split_vh_gamma", 16, None, "fused_split_hv_gamma"),
    ("1080p_to_4k_u16_gamma_rgba", "avir", 1920, 1080, 3840, 2160, 4,
     np.uint16, np.uint16,
     {"use_srgb_gamma": True, "alpha_index": 3, "res_bit_depth": 16},
     "fused_split_vh_gamma", 5, None, "fused_split_hv_gamma"),
    # Gamma-correct upscaling of 8-bit video: K1 int8 hv with the table,
    # bit-equal to its plain version.  The int8 route's 13-bit linear light
    # is 2 LSB off the float64 oracle (and off the float32 exact route) at
    # some pixels of this image, so its oracle gate is 2 LSB and >= 60 dB.
    ("1080p_to_4k_gamma", "avir", 1920, 1080, 3840, 2160, 3, np.uint8,
     np.uint8, {"use_srgb_gamma": True}, "fused_int8_hv_gamma", 2, None, None),
    # A u8 gamma downsize K6 cannot take (no uniform row stride): "auto"
    # runs K1 int8 vh with the in-kernel gamma, the gate of
    # 1080p_to_4k_gamma.
    ("640x480_gamma_down", "avir", 1000, 700, 640, 480, 3, np.uint8,
     np.uint8, {"use_srgb_gamma": True}, "fused_int8_vh_gamma", 2, None, None),
)
# The unfused route (K3 lane pass, K2 row pass): (name, entry point,
# src_w, src_h, new_w, new_h, c, out dtype, resize keywords, expected
# (order, K3 mode, K2 mode)).
UNFUSED_SHAPES = (
    ("720p_to_1080p_errdiff", "avir", 1280, 720, 1920, 1080, 3, np.uint8,
     {"dither": "errdiff"}, ("hv", "split2", "split3")),
    ("1080p_to_4k_gamma_errdiff", "avir", 1920, 1080, 3840, 2160, 3, np.uint8,
     {"dither": "errdiff", "use_srgb_gamma": True}, ("hv", "split3", "split3")),
    ("lancir_720p_to_1080p_f32", "lancir", 1280, 720, 1920, 1080, 3,
     np.float32, {}, ("hv", "split2", "split3")),
)
# The linearize-once gamma route (K5 + K1 int8 limb-plane input):
# (name, src_w, src_h, new_w, new_h, c), u8 RGB with sRGB gamma; the
# downsize runs vh, the upsize hv (both on the s8 tensor cores).
PROLOGUE_SHAPES = (
    ("8k_to_1080p_gamma_prologue", 7680, 4320, 1920, 1080, 3),
    ("1080p_to_4k_gamma_prologue", 1920, 1080, 3840, 2160, 3),
)
# K2 / K3 small cases: (src_w, src_h, new_w, new_h), cycled over every
# mode x input type x channel count.
PASS_SHAPES = ((53, 37, 90, 71), (150, 97, 61, 40), (300, 20, 1400, 41))
# K3 at the edges of its tensor-core tiling (tests/torch_cases.py's
# LANES_CASES edges): (src_w, src_h, new_w, new_h, c, in type, mode): rows
# off 64 over several row blocks, chunks whose nonzero range is one 32-lane
# step, C = 2, u8 / u16 / f32 rows on the vector path, a wide f32 upsize,
# an odd lanes_out.  Inputs from a generator of their own (seed SEED + 3).
K3_EDGE_CASES = (
    (20, 70, 200, 90, 1, "u8", "split2"),
    (64, 130, 101, 70, 2, "u16", "split2"),
    (128, 100, 200, 60, 1, "u8", "split3"),
    (640, 66, 1920, 99, 3, "f32", "split2"),
    (33, 40, 91, 50, 1, "f32", "split3"),
)
# K5 + K1 int8 limb-plane input: (src_w, src_h, new_w, new_h, c, lane
# tile, order, alpha_index).
GAMMA_PRE_CASES = (
    (200, 150, 80, 60, 3, None, "vh", -1),
    (80, 60, 200, 150, 4, None, "hv", 3),
    (150, 90, 61, 37, 1, None, "vh", -1),
    (120, 80, 70, 50, 4, 50, "vh", 0),
    (300, 20, 1400, 41, 3, None, "hv", -1),
    (29, 21, 71, 45, 4, 48, "hv", -1),
    (1031, 517, 263, 129, 4, None, "vh", 3),
    (333, 251, 1001, 777, 3, None, "hv", -1),
    # The vh tensor-core kernel's tiling edges: rows_out off 32, C = 2, a
    # downsize by more than 4, C = 5.
    (300, 250, 170, 150, 3, None, "vh", -1),
    (97, 83, 61, 45, 2, None, "vh", -1),
    (1031, 517, 200, 97, 3, None, "vh", -1),
    (90, 60, 40, 27, 5, None, "vh", -1),
    # K5's byte path (lanes off 16) with the alpha lane last and first, and
    # more than 64 16-lane groups a row on the vector path.
    (81, 64, 40, 30, 4, None, "vh", 3),
    (43, 29, 90, 61, 4, None, "hv", 0),
    (448, 40, 200, 20, 3, None, "vh", -1),
)
# K6, the shift-ring gamma route: (src_w, src_h, new_w, new_h, c,
# alpha_index, V tile, uniform blocking); tests/test_pallas_kernel.py:
# 854-862's five cases plus C = 1, then clusters of 8, 12 and 16 blocks
# (lanes_in off 4 and off 128, V ranges of 96 / 160 rows, RGBA).
RING_CASES = (
    (256, 768, 64, 192, 3, -1, 64, False),
    (128, 768, 32, 192, 4, 3, 64, False),
    (384, 512, 96, 128, 3, -1, None, False),
    (512, 1024, 128, 256, 3, -1, 64, True),
    (256, 960, 128, 480, 4, 3, 64, True),
    (640, 1024, 160, 256, 1, -1, 64, True),
    (1030, 640, 170, 160, 3, -1, None, True),
    (1024, 640, 128, 160, 3, -1, None, True),
    (2048, 640, 128, 160, 1, -1, None, True),
    (384, 720, 128, 240, 3, -1, None, True),
    (768, 640, 128, 160, 4, 3, None, True),
)
# The ring shapes' sweep of row parts a column is cut into.
RING_PARTS = (1, 2, 4, 8, 16, 32)
# K6 at full size through ImageResizer.resize(use_srgb_gamma=True) with
# AVIR_TPU_GAMMA_ROUTE=ring, u8 RGB: (name, src_w, src_h, new_w, new_h).
RING_SHAPES = (
    ("8k_to_1080p_gamma_ring", 7680, 4320, 1920, 1080),
    ("4k_to_720p_gamma_ring", 3840, 2160, 1280, 720),
)
# K7 (planar input) and K8 (interleaved input), small cases: (src_w,
# src_h, new_w, new_h, c, in type, out type, mode_v, mode_h, trunc_bits,
# gamma, alpha_index, extra pixels of K7's plane width).  The last six
# are the edges of the kernel's tensor-core tiling (tests/torch_cases.py:
# Tv of 32 and 40, h_range segments ending 32 or 96 pixels in, windows
# 32 pixels in, rows off 16 bytes and K8's raw span tile, alpha planes
# not the last, a split2 second pass with float32 output).
PLANAR_CASES = (
    (200, 150, 80, 60, 3, "u8", "f32", "split2", "split3", 0, False, -1, 0),
    (200, 150, 80, 60, 3, "u8", "u8", "split2", "split3", 0, False, -1, 0),
    (96, 80, 144, 120, 4, "u16", "u16", "split3", "split3", 0, True, 3, 0),
    (150, 90, 61, 37, 1, "f32", "f32", "split3", "split3", 0, False, -1, 0),
    (120, 80, 70, 50, 4, "u8", "u8", "split3", "split2", 2, True, 0, 0),
    (45, 31, 97, 70, 3, "u16", "u8", "split3", "split3", 0, False, -1, 0),
    (40, 30, 64, 48, 1, "u8", "u16", "split2", "split2", 2, False, -1, 0),
    (181, 77, 60, 33, 4, "f32", "u16", "split3", "split3", 0, True, 3, 0),
    (1031, 517, 263, 129, 3, "u8", "u8", "split2", "split3", 0, False, -1, 0),
    (333, 251, 1001, 777, 4, "u16", "u16", "split3", "split3", 0, True, 3, 0),
    (80, 37, 300, 29, 3, "u8", "u8", "split2", "split3", 0, False, -1, 0),
    (259, 37, 29, 29, 1, "u8", "f32", "split2", "split3", 0, False, -1, 3),
    (259, 37, 29, 29, 1, "u8", "f32", "split2", "split2", 0, False, -1, 3),
    (1000, 333, 90, 40, 1, "f32", "f32", "split3", "split3", 0, False, -1, 0),
    (200, 37, 150, 29, 3, "u16", "u16", "split3", "split3", 0, True, 1, 2),
    (131, 90, 97, 70, 4, "u8", "u8", "split2", "split3", 0, True, 0, 1),
)
# K7 and K8 at full size, called directly (no resize routes to them, as in
# the JAX package): (name, src_w, src_h, new_w, new_h, c, in dtype, out
# dtype, mode_v, mode_h, resize keywords, K1 variant of the same resize).
PLANAR_SHAPES = (
    ("8k_to_1080p_planar", 7680, 4320, 1920, 1080, 3, np.uint8, np.uint8,
     "split2", "split3", {}, "fused_split_vh"),
    ("1080p_to_4k_u16_gamma_rgba_planar", 1920, 1080, 3840, 2160, 4, np.uint16,
     np.uint16, "split3", "split3",
     {"use_srgb_gamma": True, "alpha_index": 3, "res_bit_depth": 16},
     "fused_split_vh_gamma"),
)
# --kernel-times' K7 and K8 cells: the two planar shapes.
KT_PLANAR_CELLS = PLANAR_SHAPES
# --kernel-times' K1 split hv cells (and split_hv_heights.py's): (name,
# src_w, src_h, new_w, new_h, c, in dtype, plan keywords, errdiff).  The
# errdiff upsize on the route its resize takes (hv), and the u16 RGBA gamma
# upsizes (1080p -> 4K, and 4K -> 8K, the benchmark's 16-bit cell) in the
# hv order by a direct call (no gamma resize runs hv); K1 split vh of the
# same resize beside each.
KT_SPLIT_HV_CELLS = (
    ("1080p_to_4k_errdiff", 1920, 1080, 3840, 2160, 3, np.uint8, {}, True),
    ("1080p_to_4k_u16_gamma_rgba", 1920, 1080, 3840, 2160, 4, np.uint16,
     {"use_srgb_gamma": True, "alpha_index": 3, "res_bit_depth": 16}, False),
    ("4k_to_8k_u16_gamma_rgba", 3840, 2160, 7680, 4320, 4, np.uint16,
     {"use_srgb_gamma": True, "alpha_index": 3, "res_bit_depth": 16}, False),
)
# K4's row groups swept at each errdiff cell: warps of (row, channel)
# threads per group (rows per group = warps * 32 // C).
K4_GROUP_WARPS = (1, 2, 3, 4, 8, 32)
# K4 runs compared with its plain version at each errdiff cell (a race
# between groups would show only sometimes).
K4_REPEATS = 10
# Elements of an unfused errdiff shape's output held to the serial float64
# error diffusion (its top rows; the whole of a 1080p frame).
ERRDIFF_ORACLE_ELEMS = 1920 * 1080 * 3
# --kernel-times: K1 int8 (no gamma) at its four main-path cells, u8 RGB:
# (name, entry point, src_w, src_h, new_w, new_h).
KT_INT8_CELLS = (
    ("8k_to_1080p", "avir", 7680, 4320, 1920, 1080),
    ("lancir_8k_to_1080p", "lancir", 7680, 4320, 1920, 1080),
    ("1080p_to_4k", "avir", 1920, 1080, 3840, 2160),
    ("640x480_to_1024x768", "avir", 640, 480, 1024, 768),
)
# --kernel-times' gamma cells, u8 RGB with sRGB gamma: (name, route of
# AVIR_TPU_GAMMA_ROUTE, src_w, src_h, new_w, new_h): K6 on "ring", K5 +
# K1 int8 from the limb planes on "prologue", and K1 int8 with the
# in-kernel gamma ("inkernel" at 8K; "auto", which is that route, at the
# upsize and at the downsize without a uniform row stride).
KT_GAMMA_CELLS = (
    ("8k_to_1080p_gamma_ring", "ring", 7680, 4320, 1920, 1080),
    ("4k_to_720p_gamma_ring", "ring", 3840, 2160, 1280, 720),
    ("8k_to_1080p_gamma_prologue", "prologue", 7680, 4320, 1920, 1080),
    ("1080p_to_4k_gamma_prologue", "prologue", 1920, 1080, 3840, 2160),
    ("8k_to_1080p_gamma", "inkernel", 7680, 4320, 1920, 1080),
    ("1080p_to_4k_gamma", "auto", 1920, 1080, 3840, 2160),
    ("640x480_gamma_down", "auto", 1000, 700, 640, 480),
)
# --kernel-times' K2 cells, u8 RGB through the unfused route with
# dither="errdiff" (K3, then K2 split3 on its float32 output): (name,
# src_w, src_h, new_w, new_h, plan keywords).
KT_K2_CELLS = (
    ("720p_to_1080p_errdiff", 1280, 720, 1920, 1080, {}),
    ("1080p_to_4k_gamma_errdiff", 1920, 1080, 3840, 2160, {"use_srgb_gamma": True}),
)
# --kernel-times' K3 cells: the three unfused shapes (UNFUSED_SHAPES), K3
# on the image the route gives it (u8; linear float32 with gamma): (name,
# entry point, src_w, src_h, new_w, new_h, out dtype, plan keywords).
KT_K3_CELLS = (
    ("720p_to_1080p_errdiff", "avir", 1280, 720, 1920, 1080, np.uint8, {}),
    ("1080p_to_4k_gamma_errdiff", "avir", 1920, 1080, 3840, 2160, np.uint8,
     {"use_srgb_gamma": True}),
    ("lancir_720p_to_1080p_f32", "lancir", 1280, 720, 1920, 1080, np.float32, {}),
)
NP_TYPES = {"u8": np.uint8, "u16": np.uint16, "f32": np.float32}
TORCH_TYPES = {"u8": torch.uint8, "u16": torch.uint16, "f32": torch.float32}


# ptxas's report of each library this run built ({name: log}).
BUILD_LOGS: dict[str, str] = {}


def _ptxas(lib: str, *needles: str):
    """{kernel: registers and spill bytes} that ptxas gave the kernels of
    library ``lib`` whose mangled names hold every one of ``needles``, from
    this run's build."""
    import re

    log = BUILD_LOGS.get(lib)
    if log is None:
        return "not built in this run"
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if all(n in m.group(1) for n in needles) else None
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                               spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(peak**2 / mse))


def _oracle(plan, src: np.ndarray) -> np.ndarray:
    """Float64 host oracle of a u8 resize with the default dither."""
    from avir_tpu_torch.models.host_reference import default_dither

    out = default_dither(_predither(plan, src), 0, 255.0)
    return out.astype(np.uint8)


def _predither(plan, src: np.ndarray) -> np.ndarray:
    """Float64 host oracle before the dither stage: both banded operators
    applied with apply_banded_numpy (models/host_reference.py's
    execute_plan_numpy), in slabs to bound host memory."""
    return _passes(plan.h.op, plan.v.op, src)


def _passes(hop, vop, src: np.ndarray) -> np.ndarray:
    """[H, W, C] -> float64 [new_h, new_w, C] through the banded operators
    ``hop`` (columns) and ``vop`` (rows), in slabs."""
    from avir_tpu_torch.plan.compose import apply_banded_numpy

    h, w, c = src.shape
    x = np.moveaxis(src, 1, 0).reshape(w, h * c)
    step = max(1, (1 << 27) // (hop.n_out * hop.width * 8))
    hx = np.concatenate(
        [apply_banded_numpy(hop, x[:, i : i + step])
         for i in range(0, h * c, step)],
        axis=1,
    )  # [new_w, h*c]
    x = np.moveaxis(hx.reshape(-1, h, c), 1, 0).reshape(h, -1)
    step = max(1, (1 << 27) // (vop.n_out * vop.width * 8))
    vx = np.concatenate(
        [apply_banded_numpy(vop, x[:, i : i + step])
         for i in range(0, x.shape[1], step)],
        axis=1,
    )
    return vx.reshape(vop.n_out, hop.n_out, c)


def _split_int_tol(ref_max: float, scale: float, gamma: bool) -> float:
    """K1 split vs its plain version on an integer output: 1 LSB, or, when
    a scale > 1 or gamma-out's slope amplifies the float32 difference of
    the two summation orders, the float32 gate (max * 1e-4) on the
    output's range plus one rounding step."""
    return 1.0 + (ref_max * 1e-4 if scale > 1.0 or gamma else 0.0)


def _time_ms(fn, n: int, flush: torch.Tensor) -> float:
    """Mean device ms of fn() over n runs, L2 flushed before each."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / n


def _first_pass_reads(ops) -> dict[str, float]:
    """Image bytes the kernel's first pass reads per image byte: every
    thread block reads its slice's V-tap row range over its chunk's
    win_c-lane window.  The total is the rows' factor times the lanes'."""
    kr = ops.k_range.cpu()
    rows = int((kr[..., 1] - kr[..., 0]).sum()) / ops.rows_in
    bh, n_ch, win_c, _ = ops.h1.shape
    lanes = bh * n_ch * win_c / ops.lanes_in
    return {"rows": rows, "lanes": lanes, "total": rows * lanes}


def _int8_counts(ops) -> dict:
    """K1 int8 on the tensor cores (any input: the u8 image, K5's limb
    planes, the image linearized in the kernel): the slice height, the s8
    MACs the kernel issues (fused_kernel.py:issued_macs; three first-pass
    products with gamma) and those of the dp4a design the tensor-core
    kernels replaced (32-row slices, dense over the whole win_c window: vh
    per 128-lane segment, hv per 32-row group), and the image elements the
    first pass stages per input element in both tilings (each block stages
    its slice's nonzero V-tap rows over its chunk's nonzero lane range;
    before, over the whole window)."""
    from avir_tpu_torch.ops.cuda import fused_kernel as fk

    kr = ops.k_range.cpu().numpy().astype(np.int64)
    sr = ops.slice_range.cpu().numpy().astype(np.int64)
    hr = ops.h_range.cpu().numpy().astype(np.int64)
    bh, n_ch, win_c, _ = ops.h1.shape
    k32 = int((kr[..., 1] - kr[..., 0]).sum())
    first = 3 if ops.epi.gamma else 2  # limb products of the first pass
    if ops.order == "vh":
        before = (first * 32 * k32 * win_c + 3 * 32 * 128 * win_c * kr[..., 0].size) * bh * n_ch
    else:
        before = (first * 128 * win_c + 3 * 32 * 128) * k32 * bh * n_ch
    rows = int((sr[..., 1] - sr[..., 0]).sum()) / ops.rows_in
    lanes = int((hr[..., 1] - hr[..., 0]).sum()) / ops.lanes_in
    return {
        "slice_rows": ops.rows,
        # The hv launch: its pipeline form, blocks and ring (a version
        # without runs of tiles has none).
        "hv_launch": ({"form": ops.hv_form, "blocks": ops.blocks}
                      if ops.order == "hv" and hasattr(ops, "hv_form") else None),
        "macs_issued": fk.issued_macs(ops.order, ops.rows, sr, kr, hr, first=first),
        "macs_issued_before": int(before),
        "first_pass_reads_per_input": {
            "rows": rows, "lanes": lanes, "total": rows * lanes,
            "before": _first_pass_reads(ops)["total"],
        },
    }


# Yardsticks of K1 int8: (precision, the route it takes).
EXACT_ROUTE = ("exact", "exact")
SPLIT_ROUTE = ("fast", "split")


def _height_sweep(ops, x, got, flush) -> dict:
    """K1 int8 at every slice height its order takes (fused_kernel.py:
    at_rows), timed in this run beside slice_rows' choice, in SWEEP_TURNS
    turns that alternate the heights: {rows: ms of each turn, bit-equal
    to ``got``, MACs issued}.  ``x`` is the u8 image, or K5's two limb
    planes as a tuple."""
    from avir_tpu_torch.ops.cuda import fused_kernel as fk

    args = x if isinstance(x, tuple) else (x,)

    tiled = {}
    for rows in INT8_ROWS[ops.order]:
        try:
            o = fk.at_rows(ops, rows)
        except ValueError:  # an hv range above the intermediate's rows
            continue
        y = fk.apply_fused_int8(o, *args)
        torch.cuda.synchronize()
        tiled[rows] = (o, {
            "ms": [],
            "bit_equal": bool(torch.equal(y, got)),
            "macs_issued": _int8_counts(o)["macs_issued"],
        })
    for _ in range(SWEEP_TURNS):
        for o, rec in tiled.values():
            rec["ms"].append(_time_ms(lambda: fk.apply_fused_int8(o, *args), 20, flush))
    return {rows: rec for rows, (_, rec) in tiled.items()}


def _yardsticks(make, plan, x, got, routes, dev, flush) -> dict:
    """The same resize on other routes (``routes``: EXACT_ROUTE, float32
    torch.bmm passes; SPLIT_ROUTE, K1 split vh at a downsize), each timed
    in this run beside K1 int8, with its largest difference from K1 int8's
    output ``got`` in LSB."""
    out = {}
    for precision, route in routes:
        fn = make(plan, precision=precision, device=dev)
        if fn.route != route:
            _fail(f"precision={precision!r} took the {fn.route} route, not {route}")
        y = fn(x)
        torch.cuda.synchronize()
        out[f"{route}_route_ms"] = _time_ms(lambda: fn(x), 20, flush)
        out[f"max_lsb_vs_{route}_route"] = int((y.int() - got.int()).abs().max())
        if route == "split":
            out["split_route_kernel"] = fn.ops.launch_key
    return out


def _k1_bound(h, v, c: int, order: str, in_bytes: int, out_bytes: int,
              tap_bytes: int, pv: int, ph: int, rate: float,
              f32_ops: int = 0) -> tuple[float, str, int, int]:
    """(bound_ms, bound_by, bytes, tensor ops) of one K1 launch by the
    banded operators ``h`` and ``v``: the image read once, the output
    written once and both operators once (``tap_bytes`` per tap); 2 x band
    MACs x products per pass (``pv``, ``ph``) at ``rate``; plus
    ``f32_ops`` float32 operations (the gamma stages) on the CUDA cores.
    The least time is the largest of the three."""
    lanes_in, lanes_out = h.n_in * c, h.n_out * c
    nbytes = (
        v.n_in * lanes_in * in_bytes + v.n_out * lanes_out * out_bytes
        + tap_bytes * (h.n_out * h.width + v.n_out * v.width)
    )
    if order == "vh":
        macs = v.n_out * lanes_in * v.width * pv + v.n_out * lanes_out * h.width * ph
    else:
        macs = v.n_in * lanes_out * h.width * ph + v.n_out * lanes_out * v.width * pv
    ops = 2 * macs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / rate, f32_ops / F32_OPS_PER_S)
    return (
        1e3 * max(t_bytes, t_ops),
        "bytes" if t_bytes >= t_ops else "operations",
        nbytes,
        ops,
    )


def _bound(plan, c: int, order: str, gamma: bool = False) -> tuple[float, str, int, int]:
    """K1 int8: two s8 limbs per tap; two products in the first pass
    (three with gamma), three in the second; with gamma also the float32
    gamma stages (GAMMA_IN_OPS an input element, GAMMA_OUT_OPS an output)."""
    first = 3 if gamma else 2
    pv, ph = (first, 3) if order == "vh" else (3, first)
    hop, vop = plan.h.op, plan.v.op
    f32_ops = (vop.n_in * hop.n_in * c * GAMMA_IN_OPS["int8"]
               + vop.n_out * hop.n_out * c * GAMMA_OUT_OPS) if gamma else 0
    return _k1_bound(hop, vop, c, order, 1, 1, 2, pv, ph, INT8_OPS_PER_S, f32_ops)


def _split_reads(ops) -> dict[str, float]:
    """Image elements the split kernel's first pass stages per input
    element: each thread block stages its slice's nonzero V-tap rows
    (k_range) over its chunk's nonzero lane-tap window (h_range; in vh,
    segments from its 32-aligned start).  "before": the tiling before the
    kernel's tensor-core design (32-row slices; in vh, 128-lane segments
    from a 128-aligned start)."""
    from avir_tpu_torch.ops.cuda.fused_kernel import _k_ranges

    kr = ops.k_range.cpu().long()
    hr = ops.h_range.cpu().long()
    rows = int((kr[..., 1] - kr[..., 0]).sum()) / ops.rows_in
    lanes = int((hr[..., 1] - hr[..., 0]).sum()) / ops.lanes_in
    out = {"rows": rows, "lanes": lanes, "total": rows * lanes}
    kr = _k_ranges((ops.tvh != 0).cpu().numpy(), (ops.tvl != 0).cpu().numpy(), 32)
    lo, hi = hr[..., 0], hr[..., 1]
    if ops.order == "vh":
        lo = lo // 128 * 128
        hi = torch.where(hi > lo, (hi - lo + 127) // 128 * 128 + lo, lo)
    out["before"] = (
        int((kr[..., 1] - kr[..., 0]).sum()) / ops.rows_in
        * int((hi - lo).sum()) / ops.lanes_in
    )
    return out


def _split_dense_macs(ops, rows: int | None = None) -> int:
    """MACs the split kernel issues over its dense tap blocks (2 or 3
    products a pass), at its slice height or at ``rows`` (k_range rebuilt
    at that height).  vh: each block multiplies its slice's V block over
    its k_range by the image over its chunk's lane window, then that
    intermediate by the lane-tap block.  hv: each block multiplies its
    k_range's window rows over its chunk's lane window by the lane-tap
    block, then the V taps of its rows over k_range by that intermediate;
    32 rows is the fmaf kernel's tiling before the tensor-core design."""
    from avir_tpu_torch.ops.cuda.fused_kernel import _k_ranges

    kr = ops.k_range.cpu().long().reshape(-1, 2)
    if rows is not None:
        kr = torch.from_numpy(_k_ranges((ops.tvh != 0).cpu().numpy(),
                                        (ops.tvl != 0).cpu().numpy(), rows)).long().reshape(-1, 2)
    rows = ops.rows if rows is None else rows
    hr = ops.h_range.cpu().long().reshape(-1, 2)
    k = int((kr[:, 1] - kr[:, 0]).sum())
    hw = hr[:, 1] - hr[:, 0]
    w = int(hw.sum())
    pv = 3 if ops.mode_v == "split3" else 2
    ph = 3 if ops.mode_h == "split3" else 2
    if ops.order == "vh":
        return rows * w * (k * pv + len(kr) * 128 * ph)
    return k * w * 128 * ph + rows * k * int((hw > 0).sum()) * 128 * pv


def _split_counts(ops) -> dict:
    """The split kernel's MACs issued and first-pass stagings per input
    element, in its tiling and (hv) in the fmaf kernel's 32-row tiling
    before it."""
    out = {"dense_macs": _split_dense_macs(ops),
           "first_pass_reads_per_input": _split_reads(ops)}
    if ops.order == "hv":
        out["dense_macs_before"] = _split_dense_macs(ops, 32)
    return out


def _split_bound(plan, c: int, ops, in_bytes: int, out_bytes: int):
    """K1 in split modes: bf16 hi + lo per tap; 2 products per pass for
    split2, 3 for split3, at the bf16 tensor-core rate; with gamma, its
    float32 stages (GAMMA_IN_OPS per input element, GAMMA_OUT_OPS per
    output element)."""
    f32_ops = 0
    if ops.epi.gamma:
        f32_ops = (ops.rows_in * ops.lanes_in * GAMMA_IN_OPS["split"]
                   + ops.rows_out * ops.lanes_out * GAMMA_OUT_OPS)
    return _k1_bound(
        plan.h.op, plan.v.op, c, ops.order, in_bytes, out_bytes, 4,
        3 if ops.mode_v == "split3" else 2, 3 if ops.mode_h == "split3" else 2,
        BF16_OPS_PER_S, f32_ops,
    )


def _flip_term(ops, xmax: float) -> float:
    """For float32 output after a split2 second pass (K1 split in either
    order; K7/K8, which carry no order, run V first): one bf16 ulp of the
    largest first-pass intermediate (``xmax``, the input's largest
    magnitude, times the first pass's largest absolute tap sum: a V row's
    for vh, an H column's for hv) times the second pass's largest absolute
    tap sum.  That pass multiplies bf16(v) alone, and two summation orders
    of the intermediate v can round to hi parts one ulp apart (split3's lo
    part takes the difference up).  0 for other modes."""
    vh = getattr(ops, "order", "vh") == "vh"
    if (ops.mode_h if vh else ops.mode_v) != "split2":
        return 0.0
    vsum = float((ops.tvh.double() + ops.tvl.double()).abs().sum(-1).max())
    hsum = float((ops.thh.double() + ops.thl.double()).abs().sum(2).max())
    first, second = (vsum, hsum) if vh else (hsum, vsum)
    _, e = math.frexp(xmax * first)
    return math.ldexp(1.0, e - 8) * second


def _split_gate(ops, want: torch.Tensor, xmax: float) -> float:
    """The split gate of K1 split against its plain version's output
    ``want`` on an input of largest magnitude ``xmax``: float32 within
    max * 1e-4, plus _flip_term after a split2 second pass (which needs no
    gamma-out, whose slope would scale it); integers within 1 LSB, one
    step with trunc_bits, or the float32 gate plus a step where a scale > 1
    or gamma-out amplifies it (_split_int_tol)."""
    ref_max = float(want.double().abs().max())
    if ops.out_dtype == torch.float32:
        flip = _flip_term(ops, xmax)
        if flip and ops.epi.gamma:
            raise ValueError("the flip bound holds without gamma-out")
        return ref_max * 1e-4 + flip
    if ops.trunc_bits:
        return ops.out_max / (int(ops.out_max) >> ops.trunc_bits)
    return _split_int_tol(ref_max, ops.epi.scale, ops.epi.gamma)


def _split_hv_setup(cell, gen, dev):
    """(plan, K1 split hv operands, K1 split vh operands of the same
    resize, the image on the card, its bytes per element, the output's) of
    a KT_SPLIT_HV_CELLS cell."""
    from avir_tpu_torch.models.runtime import make_avir_executor
    from avir_tpu_torch.plan.plan import build_resize_plan

    _, sw, sh, nw, nh, c, in_dt, kw, errdiff = cell
    plan = build_resize_plan(sw, sh, nw, nh, c, in_dt, in_dt, **kw)
    ops = make_avir_executor(plan, errdiff=errdiff, device=dev).ops
    other = _flipped(ops, _vop_of(plan, in_dt), _lop_of(plan, c, in_dt), dev)
    hv, vh = (ops, other) if ops.order == "hv" else (other, ops)
    src = gen.integers(0, np.iinfo(in_dt).max + 1, (sh, sw * c), dtype=in_dt)
    return (plan, hv, vh, torch.from_numpy(src).to(dev), np.dtype(in_dt).itemsize,
            hv.out_dtype.itemsize)


def _zero(mods) -> None:
    for m in mods:
        for k in m.launches:
            m.launches[k] = 0


def _counts(mods) -> dict[str, int]:
    return {k: v for m in mods for k, v in m.launches.items()}


def _vop_of(plan, in_dt):
    """The V operator blocked as the executor blocks it."""
    from avir_tpu_torch.ops.banded import block_banded

    return block_banded(plan.v.op, in_bytes=np.dtype(in_dt).itemsize)


def _lop_of(plan, c: int, in_dt):
    """The lane operator blocked as the executor blocks it."""
    from avir_tpu_torch.ops.lanes import lane_block_banded

    return lane_block_banded(plan.h.op, c, in_bytes=np.dtype(in_dt).itemsize)


def _flipped(ops, vop, lop, dev):
    """K1 split operands of the same resize in the other pass order: the
    pass that reads the image keeps its mode, the epilogue stays."""
    from avir_tpu_torch.ops.cuda import fused_split as fs

    e = ops.epi
    return fs.prepare_fused_split(
        vop, lop, "hv" if ops.order == "vh" else "vh", ops.mode_h, ops.mode_v,
        dev, out_dtype=ops.out_dtype, out_max=ops.out_max,
        trunc_bits=ops.trunc_bits, scale=e.scale, round_mode=e.round_mode,
        gamma=e.gamma, alpha_index=e.alpha_index,
        in_gamma_mult=e.in_gamma_mult, out_gamma_mult=e.out_gamma_mult,
    )


def _other_order(ops, vop, lop, x, oracle, gate, counts, bound,
                 dev, flush) -> tuple[dict, dict, bool]:
    """K1 split on the same resize in the other pass order, by a direct
    call (_flipped).  Held to its plain version within the split gate and
    to the oracle within ``gate`` (LSB of an integer output; for float32
    output, ``oracle`` is the float64 image before the dither stage), and
    timed in turns with the routed order (routed, other, other, routed);
    ``bound(ops)`` gives its bound.  (report, kernels-line entry, ok)."""
    from avir_tpu_torch.ops.cuda import fused_split as fs

    oops = _flipped(ops, vop, lop, dev)
    got = fs.apply_fused_split(oops, x)
    want = fs.apply_fused_split_reference(oops, x)
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    tol = _split_gate(oops, want, float(x.double().abs().max()))
    off = float(np.abs(got.cpu().numpy().reshape(oracle.shape).astype(np.float64)
                       - oracle.astype(np.float64)).max())
    turns = [_time_ms(lambda: fs.apply_fused_split(o, x), 10, flush)
             for o in (ops, oops, oops, ops)]
    ms = (turns[1] + turns[2]) / 2
    plain_ms = _time_ms(lambda: fs.apply_fused_split_reference(oops, x), 2, flush)
    key = oops.launch_key
    bound_ms, bound_by, nbytes, nops = bound(oops)
    report = {
        "kernel": key, "order": oops.order, "mode_v": oops.mode_v,
        "mode_h": oops.mode_h, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "band_macs": nops // 2,
        "turns_ms": {"routed": [turns[0], turns[3]], "other": turns[1:3]},
        "max_abs_err_vs_plain": err, "tol_vs_plain": tol,
        "max_vs_f64_oracle": off, "oracle_gate": gate,
        **_split_counts(oops),
        "launches_on_main_path": counts[key],
    }
    entry = {
        "name": key, "route": "cuda", "source": SOURCES[key],
        "replaces": KERNELS[key], "launches": counts[key],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }
    return report, entry, err <= tol and off <= gate


def _k4_cell(pre3: torch.Tensor, out_max: float, want: torch.Tensor,
             flush) -> tuple[dict, bool]:
    """K4 at a full-size errdiff cell: bit-equal to its plain version's
    output ``want`` (u8) in K4_REPEATS runs at the default row groups (the
    instantiation they ran, ``wf.forms``) and once at every group size of
    K4_GROUP_WARPS, each timed; (report, every run bit-equal in the
    instantiation its threads pick)."""
    from avir_tpu_torch.ops.cuda import wavefront as wf

    h, w, c = pre3.shape

    def k4(rows=None):
        return wf.errdiff_wavefront(pre3, 0, out_max, out_dtype=torch.uint8,
                                    block_rows=rows)

    equal = 0
    forms = dict(wf.forms)
    for _ in range(K4_REPEATS):
        got = k4()
        torch.cuda.synchronize()
        equal += int(torch.equal(got, want))
    forms = {k: v - forms[k] for k, v in wf.forms.items() if v > forms[k]}
    sweep = {}
    for warps in K4_GROUP_WARPS:
        rows = wf.group_rows_for(h, c, warps * 32 // c)
        got = k4(rows)
        torch.cuda.synchronize()
        sweep[warps] = {
            "rows": rows, "groups": -(-h // rows), "form": wf.launch_bound(rows * c),
            "bit_equal": bool(torch.equal(got, want)),
            "ms": _time_ms(lambda: k4(rows), 5, flush),
        }
    ms = _time_ms(k4, 10, flush)
    rows = wf.group_rows_for(h, c, None)
    crit = wf.critical_steps(h, w)
    report = {
        "k4_ms": ms, "k4_group_rows": rows, "k4_groups": -(-h // rows),
        "k4_critical_steps": crit, "k4_us_per_critical_step": 1e3 * ms / crit,
        "k4_chain_steps_blocks_in_sequence": wf.chain_steps(h, w, c),
        "k4_runs_bit_equal": f"{equal}/{K4_REPEATS}", "k4_forms": forms,
        "k4_group_sweep": sweep,
    }
    ok = equal == K4_REPEATS and all(v["bit_equal"] for v in sweep.values()) \
        and forms == {wf.launch_bound(rows * c): K4_REPEATS}
    return report, ok


def _new_shape(name, sw, sh, nw, nh, c, in_dt, bits, dither, gen, dev,
               flush, smi, mods) -> list[dict]:
    """Drive one full-precision main-path shape through
    ImageResizer.resize, check it against the plain versions and the
    float64 oracle, time its kernels, and return their kernels-line
    entries."""
    import avir_tpu_torch
    from avir_tpu_torch.models import host_reference as hr
    from avir_tpu_torch.models.runtime import (
        make_avir_executor,
        separable_pass_exact,
    )
    from avir_tpu_torch.ops.banded import block_banded
    from avir_tpu_torch.ops.cuda import fused_split as fs
    from avir_tpu_torch.ops.cuda import wavefront as wf
    from avir_tpu_torch.plan.plan import build_resize_plan

    src = gen.integers(0, np.iinfo(in_dt).max + 1, (sh, sw, c), dtype=in_dt)
    errdiff = dither == "errdiff"
    resizer = avir_tpu_torch.ImageResizer(res_bit_depth=bits)
    _zero(mods)
    t0 = time.perf_counter()
    out = resizer.resize(src, nw, nh, dither=dither, device=dev)
    first_s = time.perf_counter() - t0
    counts = _counts(mods)

    plan = build_resize_plan(sw, sh, nw, nh, c, in_dt, in_dt, res_bit_depth=bits)
    fn = make_avir_executor(plan, errdiff=errdiff, device=dev)
    ops, order = fn.ops, fn.order
    kname = f"fused_split_{order}"
    print(json.dumps({
        "main_path": name, "launches": counts, "route": fn.route,
        "order": order, "mode_v": ops.mode_v, "mode_h": ops.mode_h,
        "k1_out": str(ops.out_dtype),
    }))
    if counts[kname] != 1 or counts["wavefront"] != (1 if errdiff else 0):
        _fail(f"{name}: the split kernel or K4 was not launched once on the main "
              f"path: {counts}")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        resizer.resize(src, nw, nh, dither=dither, device=dev)
        walls.append(1e3 * (time.perf_counter() - t0))

    x = torch.from_numpy(src.reshape(sh, sw * c)).to(dev)
    got = fs.apply_fused_split(ops, x)
    torch.cuda.synchronize()
    want = fs.apply_fused_split_reference(ops, x)
    torch.cuda.synchronize()
    k1_err = float((got.double() - want.double()).abs().max())
    k1_tol = _split_gate(ops, want, float(src.max()))
    pre64 = _predither(plan, src)
    out_max = plan.out_type_max
    report = {"shape": name}
    if errdiff:
        pre_err = float(np.abs(got.cpu().numpy().reshape(nh, nw, c) - pre64).max())
        pre3 = got.reshape(nh, nw, c)
        q = wf.errdiff_wavefront(pre3, 0, out_max, out_dtype=torch.uint8)
        # K4's plain version takes seconds at these sizes: its one run is
        # also its timing.
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        q_plain = wf.errdiff_wavefront_reference(pre3, 0, out_max).to(torch.uint8)
        e1.record()
        torch.cuda.synchronize()
        k4_plain_ms = e0.elapsed_time(e1)
        k4_err = int((q.int() - q_plain.int()).abs().max())
        same_as_resize = bool(np.array_equal(q.cpu().numpy().reshape(nh, nw, c), out))
        dev_out = q
        # The serial scan carries noise only rightwards and downwards, so
        # its top rows are those of the whole image's scan: at most
        # ERRDIFF_ORACLE_ELEMS elements of them are checked.
        rows = min(nh, max(1, ERRDIFF_ORACLE_ELEMS // (nw * c)))
        t0 = time.perf_counter()
        oracle = hr.errdiff_dither(pre64[:rows], 0, out_max).astype(np.uint8)
        report["oracle_errdiff_s"] = time.perf_counter() - t0
        top = out[:rows]
        lsb = int(np.abs(top.astype(np.int32) - oracle.astype(np.int32)).max())
        psnr = _psnr(top, oracle)
        report.update({
            "max_abs_err_predither_vs_f64_oracle": pre_err,
            "predither_tol": 255.0 * 1e-4, "k4_max_abs_err_vs_plain": k4_err,
            "pixels_off_vs_oracle": int((top != oracle).sum()),
            "oracle_rows": rows,
        })
        ok = pre_err <= 255.0 * 1e-4 and k1_err <= k1_tol and k4_err == 0 \
            and lsb <= 1
    else:
        same_as_resize = bool(
            np.array_equal(got.cpu().numpy().reshape(nh, nw, c), out)
        )
        dev_out = got
        oracle = hr.default_dither(pre64, 0, out_max).astype(out.dtype)
        lsb = int(np.abs(out.astype(np.int32) - oracle.astype(np.int32)).max())
        psnr = _psnr(out, oracle, out_max)
        ok = k1_err <= k1_tol and lsb <= 4 and psnr >= 60.0
    ok = ok and out.shape == (nh, nw, c) and same_as_resize

    ms = _time_ms(lambda: fs.apply_fused_split(ops, x), 20, flush)
    plain_ms = _time_ms(lambda: fs.apply_fused_split_reference(ops, x), 2, flush)
    in_b = np.dtype(in_dt).itemsize
    out_b = 4 if errdiff else np.dtype(in_dt).itemsize
    bound_ms, bound_by, nbytes, nops = _split_bound(plan, c, ops, in_b, out_b)
    vop = _vop_of(plan, in_dt)
    hop = block_banded(plan.h.op, in_bytes=in_b)
    h_taps = torch.from_numpy(hop.taps).to(dev)
    v_taps = torch.from_numpy(vop.taps).to(dev)
    exact_ms = _time_ms(
        lambda: separable_pass_exact(
            fs.to_float32(x), hop, vop, sh, sw, c, h_taps, v_taps
        ),
        3, flush,
    )
    h2d_ms = _time_ms(lambda: torch.from_numpy(src.reshape(sh, -1)).to(dev), 5, flush)
    report.update({
        "kernel": kname, "mode_v": ops.mode_v, "mode_h": ops.mode_h,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": nbytes, "bf16_ops": nops,
        "band_macs": nops // 2, **_split_counts(ops),
        "max_abs_err_vs_plain": k1_err, "tol_vs_plain": k1_tol,
        "max_lsb_vs_f64_oracle": lsb, "psnr_vs_f64_oracle_db": psnr,
        "launches_per_resize": counts,
        "exact_route_ms": exact_ms,
        "exact_route_note": "precision='exact': both passes as float32 "
        "torch.bmm plus gathers and transposes -- several PyTorch calls, "
        "so no single library call (library_ms null)",
        "resize_first_call_s": first_s,
        "resize_cached_wall_ms": sorted(walls)[len(walls) // 2],
        "h2d_copy_ms": h2d_ms,
        "d2h_copy_ms": _time_ms(dev_out.cpu, 5, flush),
        "card": smi,
    })
    entries = [{
        "name": kname, "route": "cuda", "source": SOURCES[kname],
        "replaces": KERNELS[kname], "launches": counts[kname],
        "max_abs_err": k1_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]
    if nw * nh > sw * sh:
        # An upsize: the other pass order by a direct call, as a yardstick,
        # held to the oracle as the routed kernel is (the pre-dither image
        # for errdiff).
        oreport, oentry, o_ok = _other_order(
            ops, vop, _lop_of(plan, c, in_dt), x, pre64 if errdiff else oracle,
            255.0 * 1e-4 if errdiff else 4, counts,
            lambda o: _split_bound(plan, c, o, in_b, out_b), dev, flush,
        )
        report["other_order"] = oreport
        entries.append(oentry)
        ok = ok and o_ok
    if errdiff:
        k4_bytes = pre3.numel() * (4 + 1)
        k4_bound = 1e3 * k4_bytes / HBM_BYTES_PER_S
        k4_report, k4_ok = _k4_cell(pre3, out_max, q_plain, flush)
        ok = ok and k4_ok
        k4_ms = k4_report["k4_ms"]
        report.update({
            **k4_report, "k4_launches": counts["wavefront"],
            "k4_plain_ms": k4_plain_ms,
            "k4_bound_ms": k4_bound, "k4_bound_by": "bytes",
            "k4_bytes": k4_bytes,
        })
        entries.append({
            "name": "wavefront", "route": "cuda", "source": SOURCES["wavefront"],
            "replaces": KERNELS["wavefront"], "launches": counts["wavefront"],
            "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound, "bound_by": "bytes", "library_ms": None,
        })
    print(json.dumps(report))
    if not ok:
        _fail(
            f"{name}: shape {out.shape}, K1 vs plain {k1_err} (tol {k1_tol}), "
            f"same as resize {same_as_resize}, oracle {lsb} LSB / {psnr} dB, "
            f"report {report}"
        )
    return entries


def _epi_shape(name, entry, sw, sh, nw, nh, c, in_dt, out_dt, kw, key,
               lsb_gate, route_env, other, gen, dev, flush, smi,
               mods) -> list[dict]:
    """Drive one main-path shape of K1's epilogue variants (LANCIR's
    round-half-even, sRGB gamma) through its public entry point (with
    AVIR_TPU_GAMMA_ROUTE=``route_env`` unless None), check it against the
    plain version and the float64 oracle, time it, and return its
    kernels-line entries: the kernel's, and ``other``'s, the other pass
    order timed by a direct call."""
    import os

    import avir_tpu_torch
    from avir_tpu_torch.models.host_reference import default_dither
    from avir_tpu_torch.models.runtime import (
        GAMMA_ROUTE_ENV,
        make_avir_executor,
        make_lancir_executor,
    )
    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.ops.cuda import fused_split as fs
    from avir_tpu_torch.ops.gamma import linear_to_srgb_np, srgb_to_linear_np
    from avir_tpu_torch.plan.lancir_plan import build_lancir_plan
    from avir_tpu_torch.plan.plan import build_resize_plan

    src = gen.integers(0, np.iinfo(in_dt).max + 1, (sh, sw, c), dtype=in_dt)
    kw = dict(kw)
    bits = kw.pop("res_bit_depth", 8)
    if entry == "lancir":
        api = avir_tpu_torch.LancIR()
        plan = build_lancir_plan(sw, sh, nw, nh, c, in_dt, out_dt)
        make = make_lancir_executor
        hop, vop = plan.h, plan.v
    else:
        api = avir_tpu_torch.ImageResizer(res_bit_depth=bits)
        plan = build_resize_plan(
            sw, sh, nw, nh, c, in_dt, out_dt, res_bit_depth=bits, **kw
        )
        make = make_avir_executor
        hop, vop = plan.h.op, plan.v.op

    def call():
        return api.resize(src, nw, nh, out_dtype=out_dt, device=dev, **kw)

    if route_env is not None:
        os.environ[GAMMA_ROUTE_ENV] = route_env
    try:
        _zero(mods)
        forms = dict(fk.hv_forms)
        t0 = time.perf_counter()
        out = call()
        first_s = time.perf_counter() - t0
        counts = _counts(mods)
        # hv launches by pipeline form (runs of tiles, or one tile a block).
        forms = {k: v - forms[k] for k, v in fk.hv_forms.items() if v > forms[k]}
        fn = make(plan, device=dev)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            call()
            walls.append(1e3 * (time.perf_counter() - t0))
    finally:
        os.environ.pop(GAMMA_ROUTE_ENV, None)
    ops = fn.ops
    print(json.dumps({
        "main_path": name, "launches": {k: v for k, v in counts.items() if v},
        "hv_forms": forms, "route": fn.route, "order": fn.order, "variant": ops.launch_key,
        "gamma_route_env": route_env,
    }))
    if counts[key] != 1 or sum(counts.values()) != 1 or ops.launch_key != key:
        _fail(f"{name}: {key} was not launched once on the main path: {counts}")

    mod = fk if fn.route == "int8" else fs
    kernel = fk.apply_fused_int8 if mod is fk else fs.apply_fused_split
    plain = (
        fk.apply_fused_int8_reference if mod is fk
        else fs.apply_fused_split_reference
    )
    x = torch.from_numpy(src.reshape(sh, sw * c)).to(dev)
    got = kernel(ops, x)
    torch.cuda.synchronize()
    want = plain(ops, x)
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    tol = 0.0 if mod is fk else _split_int_tol(
        float(want.double().abs().max()), ops.epi.scale, ops.epi.gamma
    )
    same_as_resize = bool(np.array_equal(got.cpu().numpy().reshape(nh, nw, c), out))

    # Float64 oracle: models/host_reference.py's execute_lancir_numpy /
    # execute_plan_numpy (gamma branch), with slabbed passes.
    t0 = time.perf_counter()
    out_max = 255.0 if np.dtype(out_dt).itemsize == 1 else 65535.0
    if entry == "lancir":
        pre = _passes(hop, vop, src) * plan.out_mul
        oracle = np.clip(np.rint(pre), 0.0, plan.clamp).astype(out_dt)
    else:
        lin = srgb_to_linear_np(src * plan.in_gamma_mult, plan.alpha_index)
        pre = linear_to_srgb_np(_passes(hop, vop, lin), plan.alpha_index)
        oracle = default_dither(pre * plan.out_gamma_mult, 0, out_max).astype(out_dt)
    oracle_s = time.perf_counter() - t0
    lsb = int(np.abs(out.astype(np.int32) - oracle.astype(np.int32)).max())
    psnr = _psnr(out, oracle, out_max)
    ok = (
        out.shape == (nh, nw, c) and out.dtype == np.dtype(out_dt)
        and err <= tol and same_as_resize and lsb <= lsb_gate and psnr >= 60.0
    )

    ms = _time_ms(lambda: kernel(ops, x), 20, flush)
    plain_ms = _time_ms(lambda: plain(ops, x), 2, flush)
    exact = make(plan, precision="exact", device=dev)
    exact_ms = _time_ms(lambda: exact(x), 3, flush)
    exact_lsb = int((exact(x).int() - got.int()).abs().max())
    h2d_ms = _time_ms(lambda: torch.from_numpy(src.reshape(sh, -1)).to(dev), 5, flush)
    in_b, out_b = np.dtype(in_dt).itemsize, np.dtype(out_dt).itemsize
    gamma = ops.epi.gamma
    if mod is fk:
        p_first = 3 if gamma else 2
        pv, ph = (p_first, 3) if ops.order == "vh" else (3, p_first)
        tap_b, rate, reads = 2, INT8_OPS_PER_S, _first_pass_reads(ops)
    else:
        pv = 3 if ops.mode_v == "split3" else 2
        ph = 3 if ops.mode_h == "split3" else 2
        tap_b, rate, reads = 4, BF16_OPS_PER_S, _split_reads(ops)
    f32_ops = 0
    if gamma:
        f32_ops = (
            vop.n_in * hop.n_in * c * GAMMA_IN_OPS[fn.route]
            + vop.n_out * hop.n_out * c * GAMMA_OUT_OPS
        )
    bound_ms, bound_by, nbytes, nops = _k1_bound(
        hop, vop, c, ops.order, in_b, out_b, tap_b, pv, ph, rate, f32_ops
    )
    entries = [{
        "name": key, "route": "cuda", "source": SOURCES[key],
        "replaces": KERNELS[key], "launches": counts[key],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]
    extra = {}
    if route_env is not None:
        # The same resize on the route "auto" takes (the variable unset).
        auto = make(plan, device=dev)
        auto_out = auto(x)
        torch.cuda.synchronize()
        extra["auto_route"] = {
            "variant": auto.ops.launch_key,
            "ms": _time_ms(lambda: auto(x), 20, flush),
            "max_abs_diff_vs_this_route": int(
                (auto_out.int() - got.int()).abs().max()),
        }
        ok = ok and extra["auto_route"]["max_abs_diff_vs_this_route"] == 0
    if other is not None:
        def other_bound(o):
            return _k1_bound(hop, vop, c, o.order, in_b, out_b, 4,
                             3 if o.mode_v == "split3" else 2,
                             3 if o.mode_h == "split3" else 2, BF16_OPS_PER_S,
                             f32_ops)

        oreport, oentry, o_ok = _other_order(
            ops, _vop_of(plan, in_dt), _lop_of(plan, c, in_dt), x, oracle,
            lsb_gate, counts, other_bound, dev, flush,
        )
        if oentry["name"] != other:
            _fail(f"{name}: other order ran {oentry['name']}, expected {other}")
        extra["other_order"] = oreport
        entries.append(oentry)
        ok = ok and o_ok
    report = {
        "shape": name, "kernel": key, "route": fn.route,
        "order": ops.order, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "tensor_ops": nops, "f32_gamma_ops": f32_ops,
        "max_abs_err_vs_plain": err, "tol_vs_plain": tol,
        "max_lsb_vs_f64_oracle": lsb, "lsb_gate": lsb_gate,
        "max_lsb_vs_exact_route": exact_lsb,
        "psnr_vs_f64_oracle_db": psnr, "oracle_s": oracle_s,
        "pixels_off_vs_oracle": int((out != oracle).sum()),
        "pixels_off_by_2_or_more": int(
            (np.abs(out.astype(np.int32) - oracle.astype(np.int32)) >= 2).sum()),
        "first_pass_reads_per_input": reads,
        "launches_per_resize": {k: v for k, v in counts.items() if v},
        "exact_route_ms": exact_ms,
        "exact_route_note": "precision='exact': the same resize as "
        "full-float32 torch.bmm passes (and the rational gamma forms) -- "
        "several PyTorch calls, so no single library call (library_ms null)",
        "resize_first_call_s": first_s,
        "resize_cached_wall_ms": sorted(walls)[len(walls) // 2],
        "h2d_copy_ms": h2d_ms,
        "d2h_copy_ms": _time_ms(got.cpu, 5, flush), **extra,
        "card": smi,
    }
    if mod is fk:
        # The tensor-core kernels: their counts, every slice height, and
        # (no gamma) the split route at a downsize as a yardstick.
        heights = _height_sweep(ops, x, got, flush)
        ok = ok and all(h["bit_equal"] for h in heights.values())
        report.update({"band_macs": nops // 2, **_int8_counts(ops), "slice_heights": heights})
        if gamma:
            report["ptxas"] = _ptxas("fused_int8", "fused_int8")
        elif ops.order == "vh":
            report.update(_yardsticks(make, plan, x, got, (SPLIT_ROUTE,), dev, flush))
    if mod is fs:
        report.update({"mode_v": ops.mode_v, "mode_h": ops.mode_h,
                       "band_macs": nops // 2, **_split_counts(ops)})
    print(json.dumps(report))
    if not ok:
        _fail(
            f"{name}: shape {out.shape} {out.dtype}, kernel vs plain {err} "
            f"(tol {tol}), same as resize {same_as_resize}, oracle {lsb} LSB "
            f"(gate {lsb_gate}) / {psnr} dB, report {report}"
        )
    return entries


def _epi_kw(plan, rm, scale, g, alpha) -> dict:
    """K1 epilogue keyword arguments of a small case."""
    kw = dict(scale=scale, round_mode=rm)
    if g:
        kw.update(gamma=True, alpha_index=alpha, in_gamma_mult=plan.in_gamma_mult,
                  out_gamma_mult=plan.out_gamma_mult)
    return kw


def _epi_cases(gen, dev) -> None:
    """K1's epilogue variants against their plain versions, small cases."""
    from avir_tpu_torch.ops.banded import block_banded
    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.ops.lanes import lane_block_banded
    from avir_tpu_torch.plan.plan import build_resize_plan

    for sw, sh, nw, nh, c, tile, order, rm, scale, g, alpha in INT8_EPI_CASES:
        plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8,
                                 use_srgb_gamma=g, alpha_index=alpha)
        ops = fk.prepare_fused_int8(
            block_banded(plan.v.op), lane_block_banded(plan.h.op, c, tile=tile),
            order, dev, **_epi_kw(plan, rm, scale, g, alpha),
        )
        x = torch.from_numpy(
            gen.integers(0, 256, (sh, sw * c), dtype=np.uint8)
        ).to(dev)
        want = fk.apply_fused_int8_reference(ops, x)
        torch.cuda.synchronize()
        # The slice height slice_rows picked, then every other one.
        for rows in (ops.rows, *(r for r in INT8_ROWS[order] if r != ops.rows)):
            try:
                rops = fk.at_rows(ops, rows)
            except ValueError:  # an hv range above the intermediate's rows
                continue
            got = fk.apply_fused_int8(rops, x)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            case = (f"{ops.launch_key} {sw}x{sh}->{nw}x{nh} C={c} tile={tile} "
                    f"scale={scale} alpha={alpha} rows={rows}")
            print(json.dumps({"case": case, "max_abs_err": err}))
            if err != 0:
                _fail(f"kernel != plain on {case}")

    _split_epi_cases(SPLIT_EPI_CASES, gen, dev)


def _split_epi_cases(cases, gen, dev) -> None:
    """K1 split with its epilogue variants against its plain version: the
    split gate (see _epi_cases)."""
    from avir_tpu_torch.ops.banded import block_banded
    from avir_tpu_torch.ops.cuda import fused_split as fs
    from avir_tpu_torch.ops.lanes import lane_block_banded
    from avir_tpu_torch.plan.plan import build_resize_plan

    for case_t in cases:
        (sw, sh, nw, nh, c, tile, order, mv, mh, tin, tout, tb, rm, scale, g,
         alpha) = case_t
        ib = np.dtype(NP_TYPES[tin]).itemsize
        out_max = 255.0 if tout == "u8" else 65535.0
        plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout],
                                 use_srgb_gamma=g, alpha_index=alpha)
        ops = fs.prepare_fused_split(
            block_banded(plan.v.op, in_bytes=ib),
            lane_block_banded(plan.h.op, c, tile=tile, in_bytes=ib),
            order, mv, mh, dev, out_dtype=TORCH_TYPES[tout], out_max=out_max,
            trunc_bits=tb, **_epi_kw(plan, rm, scale, g, alpha),
        )
        if tin == "f32":
            xn = gen.random((sh, sw * c), dtype=np.float32)
        else:
            xn = gen.integers(0, int(np.iinfo(NP_TYPES[tin]).max) + 1,
                              (sh, sw * c), dtype=NP_TYPES[tin])
        x = torch.from_numpy(xn).to(dev)
        got = fs.apply_fused_split(ops, x)
        torch.cuda.synchronize()
        want = fs.apply_fused_split_reference(ops, x)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        tol = _split_gate(ops, want, float(np.abs(xn).max()))
        case = (f"{ops.launch_key} {sw}x{sh}->{nw}x{nh} C={c} tile={tile} "
                f"{mv}/{mh} {tin}->{tout} tb={tb} scale={scale:.6g} alpha={alpha}")
        print(json.dumps({"case": case, "max_abs_err": err, "tol": tol}))
        if not err <= tol:
            _fail(f"split kernel != plain on {case}")


def _image(gen, shape, tin: str) -> np.ndarray:
    if tin == "f32":
        return gen.random(shape, dtype=np.float32)
    dt = NP_TYPES[tin]
    return gen.integers(0, int(np.iinfo(dt).max) + 1, shape, dtype=dt)


def _unfused_cases(gen, dev) -> None:
    """K2 and K3 in every mode, u8/u16/f32 in, C in {1, 3, 4}, and K3 at
    the edges of its tiling (K3_EDGE_CASES): float32 within max|plain| *
    1e-5; K5 (on both load paths: a copy of the image at an odd address
    takes the byte path) and K1 int8's limb-plane input: bit-equal to their plain versions, and K1's
    to the in-kernel gamma kernel."""
    import itertools

    from avir_tpu_torch.ops.banded import block_banded
    from avir_tpu_torch.ops.cuda import banded_kernel as bk
    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.ops.cuda import gamma_prologue as gp
    from avir_tpu_torch.ops.cuda import lanes_kernel as lk
    from avir_tpu_torch.ops.lanes import lane_block_banded, narrow_lop
    from avir_tpu_torch.plan.plan import build_resize_plan

    def check(case, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = float(want.abs().max()) * 1e-5
        print(json.dumps({"case": case, "max_abs_err": err, "tol": tol}))
        if not (got.shape == want.shape and err <= tol):
            _fail(f"kernel != plain on {case}")

    combos = itertools.product(("u8", "u16", "f32"), (1, 3, 4))
    for i, (tin, c) in enumerate(combos):
        sw, sh, nw, nh = PASS_SHAPES[i % len(PASS_SHAPES)]
        ib = np.dtype(NP_TYPES[tin]).itemsize
        plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], np.float32)
        x = torch.from_numpy(_image(gen, (sh, sw * c), tin)).to(dev)
        vop = block_banded(plan.v.op, in_bytes=ib)
        lop = narrow_lop(plan.h.op, lane_block_banded(plan.h.op, c, in_bytes=ib),
                         c, in_bytes=ib)
        for mode in ("split2", "split3", "exact"):
            ops = bk.prepare_banded(vop, mode, dev)
            check(f"banded_{mode} {sw}x{sh}->{nw}x{nh} C={c} {tin}",
                  bk.apply_banded(ops, x), bk.apply_banded_reference(ops, x))
        for mode in ("split2", "split3"):
            ops = lk.prepare_lanes(lop, mode, dev)
            check(f"lanes_{mode} {sw}x{sh}->{nw}x{nh} C={c} {tin} tile={lop.tile}",
                  lk.apply_lanes(ops, x), lk.apply_lanes_reference(ops, x))
    egen = np.random.default_rng(SEED + 3)
    for sw, sh, nw, nh, c, tin, mode in K3_EDGE_CASES:
        ib = np.dtype(NP_TYPES[tin]).itemsize
        plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], np.float32)
        x = torch.from_numpy(_image(egen, (sh, sw * c), tin)).to(dev)
        lop = narrow_lop(plan.h.op, lane_block_banded(plan.h.op, c, in_bytes=ib),
                         c, in_bytes=ib)
        ops = lk.prepare_lanes(lop, mode, dev)
        check(f"lanes_{mode} edge {sw}x{sh}->{nw}x{nh} C={c} {tin} tile={lop.tile}",
              lk.apply_lanes(ops, x), lk.apply_lanes_reference(ops, x))

    for sw, sh, nw, nh, c, tile, order, alpha in GAMMA_PRE_CASES:
        plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8,
                                 use_srgb_gamma=True, alpha_index=alpha)
        gkw = dict(gamma=True, alpha_index=alpha,
                   in_gamma_mult=plan.in_gamma_mult,
                   out_gamma_mult=plan.out_gamma_mult)
        vop = block_banded(plan.v.op)
        lop = lane_block_banded(plan.h.op, c, tile=tile)
        pre = fk.prepare_fused_int8(vop, lop, order, dev, gamma_pre=True, **gkw)
        ink = fk.prepare_fused_int8(vop, lop, order, dev, **gkw)
        x = torch.from_numpy(_image(gen, (sh, sw * c), "u8")).to(dev)
        args = (pre.rows_pad, pre.lanes_pad, c, alpha, plan.in_gamma_mult)
        hi, lo = gp.apply_gamma_prologue(x, *args)
        # The same image at an odd address (the byte path).
        odd = torch.empty(x.numel() + 1, dtype=torch.uint8, device=dev)[1:].view(x.shape)
        odd.copy_(x)
        variants = [gp.apply_gamma_prologue(odd, *args)]
        torch.cuda.synchronize()
        phi, plo = gp.apply_gamma_prologue_reference(x, *args)
        k5_ok = all(torch.equal(h, phi) and torch.equal(l, plo)
                    for h, l in [(hi, lo), *variants])
        want = fk.apply_fused_int8_reference(pre, hi, lo)
        base = fk.apply_fused_int8(ink, x)
        # The slice height slice_rows picked, then every other one.
        for rows in (pre.rows, *(r for r in INT8_ROWS[order] if r != pre.rows)):
            try:
                o = fk.at_rows(pre, rows)
            except ValueError:  # an hv range above the intermediate's rows
                continue
            got = fk.apply_fused_int8(o, hi, lo)
            torch.cuda.synchronize()
            err_plain = int((got.int() - want.int()).abs().max())
            err_ink = int((got.int() - base.int()).abs().max())
            case = (f"{pre.launch_key} {sw}x{sh}->{nw}x{nh} C={c} tile={tile} "
                    f"alpha={alpha} rows={rows}")
            print(json.dumps({"case": case, "gamma_prologue_bit_equal": k5_ok,
                              "max_abs_err_vs_plain": err_plain,
                              "max_abs_err_vs_inkernel": err_ink}))
            if not (k5_ok and err_plain == 0 and err_ink == 0):
                _fail(f"gamma_prologue / limb-plane K1 != plain or in-kernel on {case}")


def _pass_bound(op, in_elems: int, out_elems: int, in_bytes: int,
                products: int, rate: float = BF16_OPS_PER_S
                ) -> tuple[float, str, int, int]:
    """(bound_ms, bound_by, bytes, ops) of one K2/K3 pass by the banded
    operator ``op`` over ``in_elems`` input elements to ``out_elems``
    float32 outputs: the input read once, the output written once and the
    operator's taps once (bf16 hi + lo); 2 x band MACs (``op.width`` per
    output) x products at ``rate`` (the bf16 tensor-core rate for the
    split modes' bf16 products; exact's function is one float32 MAC a tap,
    at the float32 rate, whatever implements it)."""
    nbytes = in_elems * in_bytes + out_elems * 4 + 4 * op.n_out * op.width
    ops = 2 * out_elems * op.width * products
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / rate
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations", nbytes, ops


def _k2_bound(op, x: torch.Tensor, mode: str):
    """``_pass_bound`` of K2 in ``mode`` on ``x`` [n_in, R]."""
    args = (op, x.numel(), op.n_out * x.shape[1], x.element_size())
    if mode == "exact":
        return _pass_bound(*args, 1, F32_OPS_PER_S)
    return _pass_bound(*args, 3 if mode == "split3" else 2)


def _k2_macs(ops, op, x: torch.Tensor) -> dict:
    """The MACs K2's MMAs issue on ``x`` (64-row slices x each slice's
    k_range x the 16-column groups of each 128-column block that it does
    not skip, times a step's products: split2 2, split3 3, exact 2 per
    input limb) against the band MACs of its bound (``op.width`` per
    output)."""
    from avir_tpu_torch.ops.cuda import banded_kernel as bk

    r = x.shape[1]
    products = {"split2": 2, "split3": 3}.get(ops.mode)
    if products is None:
        products = 2 * bk.EXACT_LIMBS[x.dtype]
    kr = ops.k_range.cpu().numpy().astype(np.int64)
    cols = sum(min(128, -(-(r - c0) // 16) * 16) for c0 in range(0, r, 128))
    issued = int(ops.rows * (kr[..., 1] - kr[..., 0]).sum()) * cols * products
    band = op.n_out * r * op.width
    return {"products_a_step": products, "issued_macs": issued, "band_macs": band,
            "issued_over_band": issued / band}


def _k3_macs(ops, rows: int, op) -> dict:
    """The MACs K3's MMAs issue (64-row blocks x each chunk's h_range x the
    16-lane groups it does not skip, times the split products) against the
    band MACs of its bound (``op.width`` per output), for ``rows`` rows."""
    lop = ops.lop
    tc, lanes_out = lop.tile * lop.c, lop.n_out * lop.c
    hr = ops.h_range.cpu().numpy().astype(np.int64)
    bh, n_ch = hr.shape[:2]
    col0 = np.arange(bh)[:, None] * tc + 128 * np.arange(n_ch)[None, :]
    lim = np.minimum(tc - 128 * np.arange(n_ch)[None, :], lanes_out - col0)
    groups = np.clip(-(-lim // 16), 0, 8)
    products = 3 if ops.mode == "split3" else 2
    rows64 = -(-rows // 64) * 64
    issued = int(rows64 * ((hr[..., 1] - hr[..., 0]) * 16 * groups).sum()) * products
    band = rows * lanes_out * op.width * products
    return {"k3_issued_macs": issued, "k3_band_macs": band,
            "k3_issued_over_band": issued / band,
            "k3_h_range_lanes": sorted({int(v) for v in (hr[..., 1] - hr[..., 0]).ravel()})}


def _k5_bound(n_in: int, rows_p: int, lanes_p: int) -> tuple[float, str, int]:
    """(bound_ms, bound_by, bytes) of K5: the u8 image read once and the two
    s8 planes written once; the polynomial's float32 operations once per
    input element at the CUDA cores' rate."""
    nbytes = n_in + 2 * rows_p * lanes_p
    t_b, t_o = nbytes / HBM_BYTES_PER_S, n_in * GAMMA_IN_OPS["int8"] / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations", nbytes


def _dense(op) -> np.ndarray:
    """The banded operator ``op`` as a dense float32 [n_out, n_in]."""
    d = np.zeros((op.n_out, op.n_in), np.float32)
    rows = np.arange(op.n_out)[:, None]
    d[rows, op.starts[:, None] + np.arange(op.width)[None, :]] = op.taps
    return d


def _unfused_shape(name, entry, sw, sh, nw, nh, c, out_dt, kw, expect, gen,
                   dev, flush, smi, mods) -> list[dict]:
    """Drive one shape of the unfused route (K3, K2, then K4 for error
    diffusion) through its public entry point, check each kernel against
    its plain version and the result against the float64 oracle, time
    both kernels, their pair, the fused K1 split kernel on the same shape
    and modes, and return the kernels-line entries."""
    import avir_tpu_torch
    from avir_tpu_torch.models import host_reference as hr
    from avir_tpu_torch.models.runtime import (
        make_avir_executor,
        make_lancir_executor,
        separable_pass_exact,
        separable_pass_lanes,
    )
    from avir_tpu_torch.ops.banded import apply_blocked, block_banded
    from avir_tpu_torch.ops.cuda import banded_kernel as bk
    from avir_tpu_torch.ops.cuda import fused_split as fs
    from avir_tpu_torch.ops.cuda import lanes_kernel as lk
    from avir_tpu_torch.ops.cuda import wavefront as wf
    from avir_tpu_torch.ops.gamma import (
        f32,
        linear_to_srgb_np,
        srgb_to_linear_2d,
        srgb_to_linear_np,
    )
    from avir_tpu_torch.ops.lanes import lane_block_banded
    from avir_tpu_torch.plan.lancir_plan import build_lancir_plan
    from avir_tpu_torch.plan.plan import build_resize_plan

    src = gen.integers(0, 256, (sh, sw, c), dtype=np.uint8)
    kw = dict(kw)
    dither = kw.pop("dither", "default")
    errdiff = dither == "errdiff"
    gamma = kw.get("use_srgb_gamma", False)
    if entry == "lancir":
        api = avir_tpu_torch.LancIR()
        plan = build_lancir_plan(sw, sh, nw, nh, c, np.uint8, out_dt)
        hop, vop_op = plan.h, plan.v
        fn = make_lancir_executor(plan, device=dev)

        def call():
            return api.resize(src, nw, nh, out_dtype=out_dt, device=dev)
    else:
        api = avir_tpu_torch.ImageResizer()
        plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, out_dt, **kw)
        hop, vop_op = plan.h.op, plan.v.op
        fn = make_avir_executor(plan, errdiff=errdiff, device=dev)

        def call():
            return api.resize(src, nw, nh, out_dtype=out_dt, dither=dither,
                              device=dev, **kw)

    _zero(mods)
    t0 = time.perf_counter()
    out = call()
    first_s = time.perf_counter() - t0
    counts = _counts(mods)
    ops = fn.ops
    got_route = (fn.route, fn.order, ops.lanes.mode, ops.rows.mode)
    print(json.dumps({"main_path": name, "launches": {k: v for k, v in counts.items() if v},
                      "route": fn.route, "order": fn.order,
                      "k3_mode": ops.lanes.mode, "k2_mode": ops.rows.mode}))
    k3, k2 = ops.lanes.launch_key, ops.rows.launch_key
    others = {k: v for k, v in counts.items() if v and k not in (k3, k2, "wavefront")}
    if (got_route != ("unfused", *expect) or counts[k3] != 1 or counts[k2] != 1
            or others or counts["wavefront"] != (1 if errdiff else 0)):
        _fail(f"{name}: route {got_route}, launches {counts}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        walls.append(1e3 * (time.perf_counter() - t0))

    x = torch.from_numpy(src.reshape(sh, sw * c)).to(dev)
    xin = x
    if gamma:
        xin = srgb_to_linear_2d(x.to(torch.int32).float() * f32(plan.in_gamma_mult),
                                c, plan.alpha_index)
    # Each kernel against its plain version, on the inputs the route gives it.
    if ops.order == "hv":
        a = lk.apply_lanes(ops.lanes, xin)
        a_plain = lk.apply_lanes_reference(ops.lanes, xin)
        b = bk.apply_banded(ops.rows, a)
        b_plain = bk.apply_banded_reference(ops.rows, a)
        k3_in, k2_in = xin, a
    else:
        a = bk.apply_banded(ops.rows, xin)
        a_plain = bk.apply_banded_reference(ops.rows, xin)
        b = lk.apply_lanes(ops.lanes, a)
        b_plain = lk.apply_lanes_reference(ops.lanes, a)
        k2_in, k3_in = xin, a
    torch.cuda.synchronize()
    first_err = float((a - a_plain).abs().max())
    first_tol = float(a_plain.abs().max()) * 1e-5
    second_err = float((b - b_plain).abs().max())
    second_tol = float(b_plain.abs().max()) * 1e-5
    k3_err, k3_tol, k2_err, k2_tol = (
        (first_err, first_tol, second_err, second_tol) if ops.order == "hv"
        else (second_err, second_tol, first_err, first_tol)
    )
    report = {"shape": name, "route": "unfused", "order": ops.order,
              "k3_mode": ops.lanes.mode, "k2_mode": ops.rows.mode,
              "k3_max_abs_err_vs_plain": k3_err, "k3_tol": k3_tol,
              "k2_max_abs_err_vs_plain": k2_err, "k2_tol": k2_tol}
    ok = k3_err <= k3_tol and k2_err <= k2_tol

    # Against the float64 oracle (slabbed passes).
    t0 = time.perf_counter()
    if entry == "lancir":
        oracle = hr.execute_lancir_numpy(plan, src)
        err = float(np.abs(out.astype(np.float64) - oracle).max())
        tol = float(np.abs(oracle).max()) * 1e-4
        report.update({"max_abs_err_vs_f64_oracle": err, "oracle_tol": tol})
        dev_out = fn(x)
        same_as_resize = bool(np.array_equal(dev_out.cpu().numpy().reshape(nh, nw, c), out))
        ok = ok and err <= tol
    else:
        if gamma:
            lin = srgb_to_linear_np(src * plan.in_gamma_mult, plan.alpha_index)
            pre64 = linear_to_srgb_np(_passes(hop, vop_op, lin), plan.alpha_index)
            pre64 = pre64 * plan.out_gamma_mult
        else:
            pre64 = _passes(hop, vop_op, src)
        pre = fn.predither(x)
        pre3 = pre.reshape(nh, nw, c).contiguous()
        pre_err = float(np.abs(pre3.cpu().numpy() - pre64).max())
        q = wf.errdiff_wavefront(pre3, 0, 255.0, out_dtype=torch.uint8)
        q_plain = wf.errdiff_wavefront_reference(pre3, 0, 255.0).to(torch.uint8)
        torch.cuda.synchronize()
        k4_err = int((q.int() - q_plain.int()).abs().max())
        dev_out = q
        same_as_resize = bool(np.array_equal(q.cpu().numpy().reshape(nh, nw, c), out))
        # The serial scan carries noise only rightwards and downwards, so
        # its top rows are those of the whole image's scan: at most
        # ERRDIFF_ORACLE_ELEMS elements of them are checked.
        rows = min(nh, max(1, ERRDIFF_ORACLE_ELEMS // (nw * c)))
        oracle = hr.errdiff_dither(pre64[:rows], 0, 255.0).astype(np.uint8)
        top = out[:rows]
        lsb = int(np.abs(top.astype(np.int32) - oracle.astype(np.int32)).max())
        report.update({
            "max_abs_err_predither_vs_f64_oracle": pre_err,
            "predither_tol": 255.0 * 1e-4, "k4_max_abs_err_vs_plain": k4_err,
            "max_lsb_vs_f64_oracle": lsb, "psnr_vs_f64_oracle_db": _psnr(top, oracle),
            "pixels_off_vs_oracle": int((top != oracle).sum()),
            "oracle_rows": rows,
        })
        ok = ok and pre_err <= 255.0 * 1e-4 and k4_err == 0 and lsb <= 1
    report["oracle_s"] = time.perf_counter() - t0
    ok = ok and out.shape == (nh, nw, c) and out.dtype == np.dtype(out_dt) and same_as_resize

    # Timing: each kernel, the pair, the route up to the pre-dither image,
    # the fused K1 split kernel on the same shape and modes, and one dense
    # float32 matmul per pass as the library yardstick.
    k3_ms = _time_ms(lambda: lk.apply_lanes(ops.lanes, k3_in), 20, flush)
    k2_ms = _time_ms(lambda: bk.apply_banded(ops.rows, k2_in), 20, flush)
    pair_ms = _time_ms(lambda: separable_pass_lanes(xin, ops), 10, flush)
    k3_plain_ms = _time_ms(lambda: lk.apply_lanes_reference(ops.lanes, k3_in), 2, flush)
    k2_plain_ms = _time_ms(lambda: bk.apply_banded_reference(ops.rows, k2_in), 2, flush)
    if entry == "lancir":
        route_ms = _time_ms(lambda: fn(x), 10, flush)
        epi = dict(scale=plan.out_mul, round_mode="even")
    else:
        route_ms = _time_ms(lambda: fn.predither(x), 10, flush)
        epi = dict(gamma=gamma, alpha_index=plan.alpha_index,
                   in_gamma_mult=plan.in_gamma_mult,
                   out_gamma_mult=plan.out_gamma_mult) if gamma else {}
    lop_w = lane_block_banded(hop, c)
    f_order = "vh" if nw * nh <= sw * sh else "hv"
    # The pass that reads the image keeps its mode in the fused kernel.
    m_first, m_second = (
        (ops.lanes.mode, ops.rows.mode) if ops.order == "hv"
        else (ops.rows.mode, ops.lanes.mode)
    )
    mv, mh = (m_first, m_second) if f_order == "vh" else (m_second, m_first)
    fops = fs.prepare_fused_split(ops.rows.bop, lop_w, f_order, mv, mh, dev,
                                  out_dtype=torch.float32, **epi)
    fused_ms = _time_ms(lambda: fs.apply_fused_split(fops, x), 10, flush)
    dh = torch.from_numpy(
        np.kron(_dense(hop).T, np.eye(c, dtype=np.float32))
    ).to(dev)  # [n_in*C, n_out*C], channel-diagonal
    dv = torch.from_numpy(_dense(vop_op)).to(dev)
    k3_lib_ms = _time_ms(lambda: torch.matmul(k3_in.float(), dh), 3, flush)
    k2_lib_ms = _time_ms(lambda: torch.matmul(dv, k2_in.float()), 3, flush)
    del dh, dv
    # The yardstick the port already had: the "exact" route's full-float32
    # torch.bmm passes (gathers and transposes included), per pass and for
    # the pair.
    hop_b = block_banded(hop)
    h_taps = torch.from_numpy(hop_b.taps).to(dev)
    v_taps = torch.from_numpy(ops.rows.bop.taps).to(dev)

    def h_exact(t):
        r = t.shape[0]
        y = t.reshape(r, sw, c).transpose(0, 1).reshape(sw, r * c)
        y = apply_blocked(hop_b, y, taps=h_taps)
        return y.reshape(nw, r, c).transpose(0, 1).reshape(r, nw * c)

    xin_f = xin.float()
    k3_exact_ms = _time_ms(lambda: h_exact(k3_in.float()), 5, flush)
    k2_exact_ms = _time_ms(
        lambda: apply_blocked(ops.rows.bop, k2_in, taps=v_taps), 5, flush
    )
    pair_exact_ms = _time_ms(
        lambda: separable_pass_exact(xin_f, hop_b, ops.rows.bop, sh, sw, c,
                                     h_taps, v_taps), 5, flush
    )
    k3_in_b = k3_in.element_size()
    k2_in_b = k2_in.element_size()
    p3 = 3 if ops.lanes.mode == "split3" else 2
    p2 = 3 if ops.rows.mode == "split3" else 2
    k3_bound = _pass_bound(hop, k3_in.numel(), k3_in.shape[0] * hop.n_out * c,
                           k3_in_b, p3)
    k2_bound = _pass_bound(vop_op, k2_in.numel(), vop_op.n_out * k2_in.shape[1],
                           k2_in_b, p2)
    report.update({
        "k3_ms": k3_ms, "k2_ms": k2_ms, "k3_plus_k2_ms": k3_ms + k2_ms,
        "pair_ms": pair_ms, "route_to_predither_ms": route_ms,
        "fused_k1_split_ms": fused_ms,
        "fused_k1_split": {"order": f_order, "mode_v": mv, "mode_h": mh,
                           "lane_tile": lop_w.tile, "gamma": gamma},
        "k3_plain_ms": k3_plain_ms, "k2_plain_ms": k2_plain_ms,
        "k3_library_ms": k3_lib_ms, "k2_library_ms": k2_lib_ms,
        "k3_exact_route_ms": k3_exact_ms, "k2_exact_route_ms": k2_exact_ms,
        "pair_exact_route_ms": pair_exact_ms,
        "library_note": "one full-float32 torch.matmul per pass with the "
        "dense operator (K3: channel-diagonal [n_in*C, n_out*C]); timed here, "
        "used nowhere in the port",
        "k3_bound_ms": k3_bound[0], "k3_bound_by": k3_bound[1],
        "k3_bytes": k3_bound[2], "k3_bf16_ops": k3_bound[3],
        "k2_bound_ms": k2_bound[0], "k2_bound_by": k2_bound[1],
        "k2_bytes": k2_bound[2], "k2_bf16_ops": k2_bound[3],
        "k3_lane_tile": ops.lanes.lop.tile, "k3_input": str(k3_in.dtype),
        "k3_vector_rows": k3_in.data_ptr() % 16 == 0
        and (k3_in.shape[1] * k3_in_b) % 16 == 0,
        **_k3_macs(ops.lanes, k3_in.shape[0], hop),
        "k3_ptxas": _ptxas("lanes", "lanes_mma"),
        "k2_slice_rows": ops.rows.rows, "k2_macs": _k2_macs(ops.rows, vop_op, k2_in),
        "k2_ptxas": _ptxas("banded", "banded_mma"),
        "launches_per_resize": {k: v for k, v in counts.items() if v},
        "resize_first_call_s": first_s,
        "resize_cached_wall_ms": sorted(walls)[len(walls) // 2],
        "h2d_copy_ms": _time_ms(
            lambda: torch.from_numpy(src.reshape(sh, -1)).to(dev), 3, flush),
        "d2h_copy_ms": _time_ms(lambda: dev_out.cpu(), 3, flush),
        "card": smi,
    })
    entries = [
        {"name": k3, "route": "cuda", "source": SOURCES[k3], "replaces": KERNELS[k3],
         "launches": counts[k3], "max_abs_err": k3_err, "ms": k3_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": k3_lib_ms},
        {"name": k2, "route": "cuda", "source": SOURCES[k2], "replaces": KERNELS[k2],
         "launches": counts[k2], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": k2_lib_ms},
    ]
    if name in (UNFUSED_SHAPES[0][0], UNFUSED_SHAPES[1][0]):
        off, off_ok, off_entries = _k2_off_path(
            vop_op, ops.rows.bop, x if name == UNFUSED_SHAPES[0][0] else None,
            k2_in, counts, dev, flush)
        report.update(off)
        entries += off_entries
        ok = ok and off_ok
    if errdiff:
        k4_report, k4_ok = _k4_cell(pre3, 255.0, q_plain, flush)
        report.update({**k4_report, "k4_launches": counts["wavefront"]})
        ok = ok and k4_ok
    print(json.dumps(report))
    if not ok:
        _fail(f"{name}: report {report}")
    return entries


def _k2_off_path(op, bop, image, k2_in, counts, dev, flush):
    """K2 in the modes and inputs no main-path shape runs (0 launches on
    the main path; exact is reached only by a direct call): exact on
    ``k2_in`` (K3's float32 output at this unfused cell) and, where
    ``image`` (the u8 image of 720p_to_1080p_errdiff) is given, split2 and
    exact on it and exact on it as u16 (x 257).  Each is held to its plain
    version (max|plain| * 1e-5) and timed beside it and one float32
    torch.matmul with the dense operator, with its bound (exact's: the
    bytes, and 2 x band MACs at the float32 rate) and the MACs its MMAs
    issue; exact on u8 must equal split2 on it bit for bit (one kernel,
    the same products).  Returns ({report key: cell}, ok, the kernels-line
    entries of split2 and exact on the u8 image)."""
    from avir_tpu_torch.ops.cuda import banded_kernel as bk

    runs = [("exact_f32", "exact", k2_in)]
    if image is not None:
        u16 = torch.from_numpy(image.cpu().numpy().astype(np.uint16) * 257).to(dev)
        runs = [("split2", "split2", image), ("exact", "exact", image),
                ("exact_u16", "exact", u16), *runs]
    dv = torch.from_numpy(_dense(op)).to(dev)
    report, entries, outs, ok = {}, [], {}, True
    for key, mode, x in runs:
        o2 = bk.prepare_banded(bop, mode, dev)
        got = bk.apply_banded(o2, x)
        want = bk.apply_banded_reference(o2, x)
        torch.cuda.synchronize()
        outs[key] = got
        err = float((got - want).abs().max())
        tol = float(want.abs().max()) * 1e-5
        b_ = _k2_bound(op, x, mode)
        xf = x.to(torch.int32).float() if x.dtype == torch.uint16 else x.float()
        cell = {
            "ms": _time_ms(lambda: bk.apply_banded(o2, x), 20, flush),
            "plain_ms": _time_ms(lambda: bk.apply_banded_reference(o2, x), 2, flush),
            "library_ms": _time_ms(lambda: torch.matmul(dv, xf), 3, flush),
            "bound_ms": b_[0], "bound_by": b_[1], "bytes": b_[2],
            "bound_ops": b_[3], "max_abs_err": err, "tol": tol,
            **_k2_macs(o2, op, x), "slice_rows": o2.rows,
            "launches_on_main_path": counts[o2.launch_key],
            "input": f"{x.dtype} {list(x.shape)}",
        }
        report[f"k2_{key}_off_path"] = cell
        ok = ok and err <= tol
        if key in ("split2", "exact"):
            entries.append({
                "name": o2.launch_key, "route": "cuda",
                "source": SOURCES[o2.launch_key], "replaces": KERNELS[o2.launch_key],
                "launches": counts[o2.launch_key], "max_abs_err": err,
                **{k: cell[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
            })
    if image is not None:
        same = bool(torch.equal(outs["exact"], outs["split2"]))
        report["k2_exact_u8_equals_split2"] = same
        ok = ok and same
    del dv
    return report, ok, entries


def _prologue_shape(name, sw, sh, nw, nh, c, gen, dev, flush, smi, mods) -> list[dict]:
    """A PROLOGUE_SHAPES cell: ImageResizer.resize with sRGB gamma under
    AVIR_TPU_GAMMA_ROUTE=prologue: one K5 launch and one K1 int8
    limb-plane launch (on the s8 tensor cores: vh at the downsize, hv at
    the upsize), bit-equal to the in-kernel route on the same image; K5
    and K1 timed apart beside the in-kernel K1 of the same run, with the
    ptxas registers and spills of the limb-plane kernel; hv also at every
    slice height (bit-equal, timed in SWEEP_TURNS alternating turns)."""
    import os

    import avir_tpu_torch
    from avir_tpu_torch.models.runtime import GAMMA_ROUTE_ENV, make_avir_executor
    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.ops.cuda import gamma_prologue as gp
    from avir_tpu_torch.plan.plan import build_resize_plan

    src = gen.integers(0, 256, (sh, sw, c), dtype=np.uint8)
    api = avir_tpu_torch.ImageResizer()
    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=True)
    os.environ[GAMMA_ROUTE_ENV] = "prologue"
    try:
        _zero(mods)
        t0 = time.perf_counter()
        out = api.resize(src, nw, nh, use_srgb_gamma=True, device=dev)
        first_s = time.perf_counter() - t0
        counts = _counts(mods)
        fn = make_avir_executor(plan, device=dev)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            api.resize(src, nw, nh, use_srgb_gamma=True, device=dev)
            walls.append(1e3 * (time.perf_counter() - t0))
        os.environ[GAMMA_ROUTE_ENV] = "inkernel"
        ink = make_avir_executor(plan, device=dev)
    finally:
        del os.environ[GAMMA_ROUTE_ENV]
    ops, iops = fn.ops, ink.ops
    key = ops.launch_key
    print(json.dumps({"main_path": name, "launches": {k: v for k, v in counts.items() if v},
                      "route": fn.route, "variant": key}))
    if (key != f"fused_int8_{fn.order}_gamma_pre" or counts[key] != 1
            or counts["gamma_prologue"] != 1 or sum(counts.values()) != 2):
        _fail(f"{name}: launches {counts}, variant {key}")

    x = torch.from_numpy(src.reshape(sh, sw * c)).to(dev)
    args = (ops.rows_pad, ops.lanes_pad, c, plan.alpha_index, plan.in_gamma_mult)
    hi, lo = gp.apply_gamma_prologue(x, *args)
    phi, plo = gp.apply_gamma_prologue_reference(x, *args)
    torch.cuda.synchronize()
    k5_err = max(int((hi.int() - phi.int()).abs().max()),
                 int((lo.int() - plo.int()).abs().max()))
    k5_eq = k5_err == 0
    got = fk.apply_fused_int8(ops, hi, lo)
    want = fk.apply_fused_int8_reference(ops, hi, lo)
    base = fk.apply_fused_int8(iops, x)
    torch.cuda.synchronize()
    k1_err = int((got.int() - want.int()).abs().max())
    vs_inkernel = int((got.int() - base.int()).abs().max())
    same_as_resize = bool(np.array_equal(got.cpu().numpy().reshape(nh, nw, c), out))
    ok = k5_eq and k1_err == 0 and vs_inkernel == 0 and same_as_resize

    k5_ms = _time_ms(lambda: gp.apply_gamma_prologue(x, *args), 20, flush)
    k1_ms = _time_ms(lambda: fk.apply_fused_int8(ops, hi, lo), 20, flush)
    route_ms = _time_ms(lambda: fn(x), 10, flush)
    ink_ms = _time_ms(lambda: fk.apply_fused_int8(iops, x), 20, flush)
    k5_plain_ms = _time_ms(lambda: gp.apply_gamma_prologue_reference(x, *args), 2, flush)
    k1_plain_ms = _time_ms(lambda: fk.apply_fused_int8_reference(ops, hi, lo), 2, flush)
    rows_p, lanes_p = hi.shape
    k5_bound = _k5_bound(sh * sw * c, rows_p, lanes_p)
    k1_bound = _k1_bound(plan.h.op, plan.v.op, c, fn.order, 2, 1, 2, 3, 3, INT8_OPS_PER_S,
                         nh * nw * c * GAMMA_OUT_OPS)
    heights = {}
    if fn.order == "hv":
        heights = _height_sweep(ops, (hi, lo), want, flush)
        ok = ok and all(h["bit_equal"] for h in heights.values())
    report = {
        "shape": name, "route": "int8 + prologue", "variant": key,
        "gamma_prologue_bit_equal_to_plain": k5_eq,
        "k1_pre_max_abs_err_vs_plain": k1_err,
        "max_abs_err_vs_inkernel_route": vs_inkernel,
        "k5_ms": k5_ms, "k1_pre_ms": k1_ms, "k5_plus_k1_ms": k5_ms + k1_ms,
        "route_ms": route_ms, "inkernel_k1_ms": ink_ms,
        "k5_plain_ms": k5_plain_ms, "k1_pre_plain_ms": k1_plain_ms,
        "k5_bound_ms": k5_bound[0], "k5_bound_by": k5_bound[1], "k5_bytes": k5_bound[2],
        "k5_path": gp.load_path(x),
        "k5_ptxas": _ptxas("gamma_prologue", "gamma_prologue"),
        "k1_pre_bound_ms": k1_bound[0], "k1_pre_bound_by": k1_bound[1],
        "planes": [rows_p, lanes_p],
        **_int8_counts(ops), "kwin": ops.kwin, "slice_heights": heights,
        "ptxas": _ptxas("fused_int8", f"fused_int8_{fn.order}_mma", "Lb1E"),
        "launches_per_resize": {k: v for k, v in counts.items() if v},
        "resize_first_call_s": first_s,
        "resize_cached_wall_ms": sorted(walls)[len(walls) // 2],
        "card": smi,
    }
    print(json.dumps(report))
    if not ok:
        _fail(f"{name}: report {report}")
    return [
        {"name": "gamma_prologue", "route": "cuda", "source": SOURCES["gamma_prologue"],
         "replaces": KERNELS["gamma_prologue"], "launches": counts["gamma_prologue"],
         "max_abs_err": k5_err, "ms": k5_ms, "plain_ms": k5_plain_ms,
         "bound_ms": k5_bound[0], "bound_by": k5_bound[1], "library_ms": None},
        {"name": key, "route": "cuda", "source": SOURCES[key], "replaces": KERNELS[key],
         "launches": counts[key], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None},
    ]


def _gamma_kw(plan) -> dict:
    return dict(gamma=True, in_gamma_mult=plan.in_gamma_mult,
                out_gamma_mult=plan.out_gamma_mult)


def _ring_cases(gen, dev) -> None:
    """K6 against its plain version and K1's in-kernel gamma kernel:
    bit-equal."""
    from avir_tpu_torch.ops.banded import block_banded
    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.ops.cuda import fused_ring as fr
    from avir_tpu_torch.ops.lanes import lane_block_banded
    from avir_tpu_torch.plan.plan import build_resize_plan

    for sw, sh, nw, nh, c, alpha, tile, uniform in RING_CASES:
        plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8,
                                 use_srgb_gamma=True, alpha_index=alpha)
        gkw = dict(alpha_index=alpha, in_gamma_mult=plan.in_gamma_mult,
                   out_gamma_mult=plan.out_gamma_mult)
        lop = lane_block_banded(plan.h.op, c)
        ops = fr.prepare_fused_ring(
            block_banded(plan.v.op, tile=tile, uniform=uniform), lop, dev, **gkw
        )
        ink = fk.prepare_fused_int8(block_banded(plan.v.op, tile=tile), lop, "vh",
                                    dev, gamma=True, **gkw)
        x = torch.from_numpy(_image(gen, (sh, sw * c), "u8")).to(dev)
        got = fr.apply_fused_ring(ops, x)
        torch.cuda.synchronize()
        err_plain = int((got.int() - fr.apply_fused_ring_reference(ops, x).int()).abs().max())
        err_ink = int((got.int() - fk.apply_fused_int8(ink, x).int()).abs().max())
        case = (f"{ops.launch_key} {sw}x{sh}->{nw}x{nh} C={c} tile={tile} "
                f"uniform={uniform} pad_top={ops.pad_top} alpha={alpha} "
                f"cluster={ops.cluster}")
        print(json.dumps({"case": case, "max_abs_err_vs_plain": err_plain,
                          "max_abs_err_vs_inkernel": err_ink}))
        if err_plain or err_ink:
            _fail(f"ring kernel != plain or in-kernel on {case}")


def _planar_ops(plan, c, mv, mh, out_dt, out_max, tb, g, alpha, dev):
    """(vop, pop, K7 operands, K8 operands) of one planar resize."""
    from avir_tpu_torch.ops.banded import block_banded
    from avir_tpu_torch.ops.cuda import planar as pk
    from avir_tpu_torch.ops.cuda import planar2 as p2
    from avir_tpu_torch.ops.lanes import lane_block_banded

    in_b = 4 if plan.is_in_float else (1 if plan.in_type_max == 255.0 else 2)
    vop = block_banded(plan.v.op, in_bytes=in_b)
    pop = lane_block_banded(plan.h.op, 1, in_bytes=in_b)
    kw = dict(mode_v=mv, mode_h=mh, out_dtype=out_dt, out_max=out_max, trunc_bits=tb)
    if g:
        kw.update(_gamma_kw(plan))
    return (vop, pop, pk.prepare_planar(vop, pop, c, dev, alpha_plane=alpha, **kw),
            p2.prepare_planar2(vop, pop, c, dev, alpha_index=alpha, **kw))


def _unaligned_copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied to a base one element past a 16-byte boundary: the same
    image on K8's strided loads (planar.raw_row_bytes gives 0)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def _planar_cases(gen, dev) -> None:
    """K7 and K8 against their plain versions, K8 by its raw span tile
    (where the case allows one) and by strided loads (an unaligned copy):
    the split gate, with the flip term of a split2 second pass
    (_planar_tol)."""
    from avir_tpu_torch.ops.cuda import planar as pk
    from avir_tpu_torch.ops.cuda import planar2 as p2
    from avir_tpu_torch.plan.plan import build_resize_plan

    for sw, sh, nw, nh, c, tin, tout, mv, mh, tb, g, alpha, pad in PLANAR_CASES:
        out_max = 65535.0 if tout == "u16" else 255.0
        plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout],
                                 res_bit_depth=16 if tout == "u16" else 8,
                                 use_srgb_gamma=g, alpha_index=alpha)
        x = torch.from_numpy(_image(gen, (sh, sw * c), tin)).to(dev)
        vop, pop, k7, k8 = _planar_ops(plan, c, mv, mh, TORCH_TYPES[tout], out_max,
                                       tb, g, alpha, dev)
        xp = pk.deinterleave(x, sh, sw, c, pk.plane_stride(vop), max(sw, pop.lanes_pad) + pad)
        xmax = float(x.double().abs().max())
        for ops, src, kernel, plain in (
            (k7, xp, pk.apply_planar, pk.apply_planar_reference),
            (k8, x, p2.apply_planar2, p2.apply_planar2_reference),
            (k8, _unaligned_copy(x), p2.apply_planar2, p2.apply_planar2_reference),
        ):
            got = kernel(ops, src)
            torch.cuda.synchronize()
            want = plain(ops, src)
            err = float((got.double() - want.double()).abs().max())
            tol = _planar_tol(ops, tout, float(want.double().abs().max()), xmax, out_max, tb, g)
            case = (f"{ops.launch_key} raw_ld={pk.raw_row_bytes(ops, src)} "
                    f"{sw}x{sh}->{nw}x{nh} C={c} {mv}/{mh} "
                    f"{tin}->{tout} tb={tb} gamma={g} alpha={alpha} wp={src.shape[1]}")
            print(json.dumps({"case": case, "max_abs_err": err, "tol": tol}))
            if not (got.shape == want.shape and err <= tol):
                _fail(f"planar kernel != plain on {case}")


def _planar_tol(ops, tout, ref_max, xmax, out_max, tb, g) -> float:
    """K7 / K8 against its plain version on an input of largest magnitude
    ``xmax``: the split gate (float32 within max * 1e-4, plus _flip_term
    after a split2 second pass; integers 1 LSB, one step with trunc_bits,
    or the float32 gate plus a step through gamma-out)."""
    if tout != "f32":
        return out_max / (int(out_max) >> tb) if tb else _split_int_tol(ref_max, 1.0, g)
    flip = _flip_term(ops, xmax)
    if flip and g:
        raise ValueError("the flip bound holds without gamma-out")
    return ref_max * 1e-4 + flip


def _ring_shape(name, sw, sh, nw, nh, gen, dev, flush, smi, mods) -> list[dict]:
    """One full-size shape of the ring route: ImageResizer.resize with sRGB
    gamma under AVIR_TPU_GAMMA_ROUTE=ring runs one K6 launch, bit-equal to
    K6's plain version and to the "auto", in-kernel and prologue routes on
    the same image; K6 timed beside the in-kernel and prologue routes in
    the same run."""
    import os

    import avir_tpu_torch
    from avir_tpu_torch.models.runtime import GAMMA_ROUTE_ENV, make_avir_executor
    from avir_tpu_torch.ops.banded import block_banded
    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.ops.cuda import fused_ring as fr
    from avir_tpu_torch.ops.lanes import lane_block_banded
    from avir_tpu_torch.plan.plan import build_resize_plan

    c = 3
    src = gen.integers(0, 256, (sh, sw, c), dtype=np.uint8)
    api = avir_tpu_torch.ImageResizer()
    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=True)
    os.environ[GAMMA_ROUTE_ENV] = "ring"
    try:
        _zero(mods)
        t0 = time.perf_counter()
        out = api.resize(src, nw, nh, use_srgb_gamma=True, device=dev)
        first_s = time.perf_counter() - t0
        counts = _counts(mods)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            api.resize(src, nw, nh, use_srgb_gamma=True, device=dev)
            walls.append(1e3 * (time.perf_counter() - t0))
        ring_fn = make_avir_executor(plan, device=dev)
        routes = {}
        for route in ("prologue", "inkernel"):
            os.environ[GAMMA_ROUTE_ENV] = route
            routes[route] = make_avir_executor(plan, device=dev)
    finally:
        del os.environ[GAMMA_ROUTE_ENV]
    routes["auto"] = make_avir_executor(plan, device=dev)
    ink = routes["inkernel"]
    ops = ring_fn.ops
    key = ops.launch_key
    print(json.dumps({"main_path": name, "launches": {k: v for k, v in counts.items() if v},
                      "route": ring_fn.route, "order": ring_fn.order, "variant": key}))
    if key != "fused_ring_vh_gamma" or counts[key] != 1 or sum(counts.values()) != 1:
        _fail(f"{name}: launches {counts}, variant {key}")

    x = torch.from_numpy(src.reshape(sh, sw * c)).to(dev)
    got = fr.apply_fused_ring(ops, x)
    want = fr.apply_fused_ring_reference(ops, x)
    base = fk.apply_fused_int8(ink.ops, x)
    pre = routes["prologue"](x)
    auto = routes["auto"](x)
    torch.cuda.synchronize()
    errs = {k: int((got.int() - v.int()).abs().max())
            for k, v in (("plain", want), ("auto_route", auto), ("inkernel_route", base),
                         ("prologue_route", pre))}
    same_as_resize = bool(np.array_equal(got.cpu().numpy().reshape(nh, nw, c), out))
    ok = not any(errs.values()) and same_as_resize

    ms = _time_ms(lambda: fr.apply_fused_ring(ops, x), 20, flush)
    ink_ms = _time_ms(lambda: fk.apply_fused_int8(ink.ops, x), 20, flush)
    pre_ms = _time_ms(lambda: routes["prologue"](x), 20, flush)
    ms_again = _time_ms(lambda: fr.apply_fused_ring(ops, x), 20, flush)
    plain_ms = _time_ms(lambda: fr.apply_fused_ring_reference(ops, x), 2, flush)
    # How the column's cut into parts trades the preloads against the
    # blocks in flight (the route's default is ops.part_ptr's).
    vop_ring, lop = block_banded(plan.v.op, uniform=True), lane_block_banded(plan.h.op, c)
    sweep = {}
    for parts in RING_PARTS:
        o = fr.prepare_fused_ring(vop_ring, lop, dev, in_gamma_mult=plan.in_gamma_mult,
                                  out_gamma_mult=plan.out_gamma_mult, parts=parts)
        sweep[parts] = {
            "ms": _time_ms(lambda: fr.apply_fused_ring(o, x), 10, flush),
            "blocks": o.chunk_of.shape[0] * o.cluster * (o.part_ptr.shape[0] - 1),
            "linearizations_per_input": fr.linearizations_per_input(o),
        }
    f32_ops = sh * sw * c * GAMMA_IN_OPS["int8"] + nh * nw * c * GAMMA_OUT_OPS
    bound_ms, bound_by, nbytes, nops = _k1_bound(
        plan.h.op, plan.v.op, c, "vh", 1, 1, 2, 3, 3, INT8_OPS_PER_S, f32_ops
    )
    k1 = ops.k1
    report = {
        "shape": name, "kernel": key, "route": "int8 ring",
        "max_abs_err_vs": errs, "same_as_resize": same_as_resize,
        "ms": ms, "ms_again": ms_again, "inkernel_k1_ms": ink_ms,
        "prologue_route_ms": pre_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "int8_ops": nops, "f32_gamma_ops": f32_ops,
        "linearizations_per_input": fr.linearizations_per_input(ops),
        "inkernel_first_pass_reads_per_input": _first_pass_reads(ink.ops),
        "ring_operator": list(k1.v1.shape), "delta": ops.delta, "n_pre": ops.n_pre,
        "pad_top": ops.pad_top, "ring_rows": ops.ring_rows,
        "cluster": ops.cluster, "clusters": ops.chunk_of.shape[0],
        "blocks_owning_a_segment": int((ops.seg_of >= 0).sum()),
        "smem_bytes": ops.smem_bytes,
        "clusters_resident": fr.resident_clusters(ops.cluster, ops.ring_rows, dev),
        "ptxas": _ptxas("fused_ring", "fused_ring_vh"),
        "parts": ops.part_ptr.shape[0] - 1, "slices": ops.slices.shape[0],
        "parts_sweep": sweep, "auto_route_variant": routes["auto"].ops.launch_key,
        "launches_per_resize": {k: v for k, v in counts.items() if v},
        "resize_first_call_s": first_s,
        "resize_cached_wall_ms": sorted(walls)[len(walls) // 2],
        "card": smi,
    }
    print(json.dumps(report))
    if not ok:
        _fail(f"{name}: report {report}")
    return [{
        "name": key, "route": "cuda", "source": SOURCES[key], "replaces": KERNELS[key],
        "launches": counts[key], "max_abs_err": errs["plain"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }]


def _planar_setup(sw, sh, nw, nh, c, in_dt, out_dt, mv, mh, kw, gen, dev):
    """One full-size planar shape: (plan, gamma, alpha, output dtype and
    range, its random image [sh, sw*c] on the card, and K1 split's operands
    of the same resize, modes and epilogue, in the order the resize would
    run it (runtime.choose_fused))."""
    from avir_tpu_torch.models.runtime import choose_fused
    from avir_tpu_torch.ops.banded import block_banded
    from avir_tpu_torch.ops.cuda import fused_split as fs
    from avir_tpu_torch.ops.lanes import lane_block_banded
    from avir_tpu_torch.plan.plan import build_resize_plan

    kw = dict(kw)
    bits = kw.pop("res_bit_depth", 8)
    g, alpha = kw.get("use_srgb_gamma", False), kw.get("alpha_index", -1)
    out_max = 255.0 if np.dtype(out_dt).itemsize == 1 else 65535.0
    plan = build_resize_plan(sw, sh, nw, nh, c, in_dt, out_dt, res_bit_depth=bits, **kw)
    out_t = TORCH_TYPES["u8" if out_max == 255.0 else "u16"]
    src = gen.integers(0, np.iinfo(in_dt).max + 1, (sh, sw, c), dtype=in_dt)
    x = torch.from_numpy(src.reshape(sh, sw * c)).to(dev)
    in_b = np.dtype(in_dt).itemsize
    vop1 = block_banded(plan.v.op, in_bytes=in_b)
    lop1 = lane_block_banded(plan.h.op, c, in_bytes=in_b)
    k1 = fs.prepare_fused_split(
        vop1, lop1, choose_fused(vop1, lop1, mv, g, c, in_b)[1], mv, mh, dev,
        out_dtype=out_t, out_max=out_max,
        **(dict(_gamma_kw(plan), alpha_index=alpha) if g else {}),
    )
    return plan, g, alpha, out_t, out_max, x, k1


def _planar_bound(plan, c, in_dt, out_dt, mv, mh, g):
    """(bound_ms, bound_by, bytes, bf16 ops, float32 gamma ops) of one K7
    or K8 launch: K1's bound at C channels (the image and the output once,
    both operators once, 2 x band MACs x products per pass at the bf16
    rate; gamma's float32 operations on the CUDA cores)."""
    sh, sw = plan.v.op.n_in, plan.h.op.n_in
    nh, nw = plan.v.op.n_out, plan.h.op.n_out
    f32_ops = (sh * sw * c * GAMMA_IN_OPS["split"] + nh * nw * c * GAMMA_OUT_OPS) if g else 0
    bound = _k1_bound(plan.h.op, plan.v.op, c, "vh", np.dtype(in_dt).itemsize,
                      np.dtype(out_dt).itemsize, 4, 3 if mv == "split3" else 2,
                      3 if mh == "split3" else 2, BF16_OPS_PER_S, f32_ops)
    return (*bound, f32_ops)


def _planar_counts(ops, pixels_in: int) -> dict:
    """The MACs K7's / K8's MMAs issue, the image elements the kernel
    stages per input element, and the 32-deep steps its blocks run.  Every
    block (a 64-row slice with nonzero V taps x a chunk with nonzero H taps
    x a channel) multiplies its slice's dense V block over its k_range by
    the image over the chunk's h_range (2 or 3 products), then that
    intermediate by the dense H block over the h_range for the chunk's
    16-pixel groups below Th (2 or 3 products), and stages its k_range rows
    x h_range pixels of the image: k_range / 32 first-pass steps for each
    128-pixel segment of the h_range and h_range / 32 second-pass steps."""
    kw = (ops.k_range[..., 1] - ops.k_range[..., 0]).cpu().long().reshape(-1)
    hr = ops.h_range.cpu().long()
    hw = (hr[..., 1] - hr[..., 0]).reshape(-1)
    j = torch.arange(hw.numel()) % hr.shape[1]
    groups = torch.clamp((ops.th - 128 * j + 15) // 16, 0, 8)
    pv = 3 if ops.mode_v == "split3" else 2
    ph = 3 if ops.mode_h == "split3" else 2
    first = int(kw.sum()) * int(hw.sum()) * pv
    second = int((kw > 0).sum()) * int((hw * 16 * groups).sum()) * ph
    segs = (hw + 127) // 128
    steps = int(kw.sum()) // 32 * int(segs.sum()) + int((kw > 0).sum()) * int(hw.sum()) // 32
    from avir_tpu_torch.ops.cuda import planar as pk

    return {
        "slice_rows": pk.ROWS,
        "macs_issued": ops.c * pk.ROWS * (first + second),
        "staged_per_input": int(kw.sum()) * int(hw.sum()) / pixels_in,
        "blocks": ops.c * int((kw > 0).sum()) * int((hw > 0).sum()),
        "steps": ops.c * steps,
    }


def _planar_shape(name, sw, sh, nw, nh, c, in_dt, out_dt, mv, mh, kw, k1_key,
                  gen, dev, flush, smi, mods) -> list[dict]:
    """One full-size shape of K7 and K8, called as a user would (no resize
    routes to them): deinterleave -> K7 -> reinterleave, and K8 ->
    regroup_channels, with the launch counts set to 0 just before and read
    just after.  Each kernel within the split gate of its plain version;
    timed beside K1 split of the same resize and the exact route."""
    from avir_tpu_torch.models.runtime import make_avir_executor
    from avir_tpu_torch.ops.cuda import fused_split as fs
    from avir_tpu_torch.ops.cuda import planar as pk
    from avir_tpu_torch.ops.cuda import planar2 as p2

    plan, g, alpha, out_t, out_max, x, k1 = _planar_setup(
        sw, sh, nw, nh, c, in_dt, out_dt, mv, mh, kw, gen, dev)
    vop, pop, k7, k8 = _planar_ops(plan, c, mv, mh, out_t, out_max, 0, g, alpha, dev)
    hp, wp = pk.plane_stride(vop), max(sw, pop.lanes_pad)
    bv_tv = vop.n_blocks * vop.tile

    _zero(mods)
    xp = pk.deinterleave(x, sh, sw, c, hp, wp)
    res7 = pk.reinterleave(pk.apply_planar(k7, xp), c, bv_tv, nh, nw)
    res8 = p2.regroup_channels(p2.apply_planar2(k8, x), c, pop.tile, nh, nw)
    torch.cuda.synchronize()
    counts = _counts(mods)
    print(json.dumps({"main_path": name, "launches": {k: v for k, v in counts.items() if v},
                      "mode_v": mv, "mode_h": mh}))
    if counts["planar"] != 1 or counts["planar2"] != 1 or sum(counts.values()) != 2:
        _fail(f"{name}: launches {counts}")

    if k1.launch_key != k1_key:
        _fail(f"{name}: K1 variant {k1.launch_key}, expected {k1_key}")
    k1_out = fs.apply_fused_split(k1, x)
    bound = _planar_bound(plan, c, in_dt, out_dt, mv, mh, g)
    raw_ld = pk.raw_row_bytes(k8, x)
    report = {"shape": name, "kernels": ["planar", "planar2"], "mode_v": mv, "mode_h": mh,
              "k8_design": f"a block a channel; raw span tile, {raw_ld} B a row" if raw_ld
              else "a block a channel; loads at a stride of C"}
    entries, ok = [], True
    for key, ops, inp, kernel, plain, res in (
        ("planar", k7, xp, pk.apply_planar, pk.apply_planar_reference, res7),
        ("planar2", k8, x, p2.apply_planar2, p2.apply_planar2_reference, res8),
    ):
        got = kernel(ops, inp)
        want = plain(ops, inp)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        tol = _split_int_tol(float(want.double().abs().max()), 1.0, g)
        ms = _time_ms(lambda: kernel(ops, inp), 10, flush)
        plain_ms = _time_ms(lambda: plain(ops, inp), 2, flush)
        vs_k1 = int((res.int() - k1_out.int()).abs().max())
        report[key] = {
            "max_abs_err_vs_plain": err, "tol_vs_plain": tol, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "bytes": bound[2], "bf16_ops": bound[3], "band_macs": bound[3] // 2,
            "f32_gamma_ops": bound[4], **_planar_counts(ops, sh * sw),
            "max_abs_diff_vs_k1_split": vs_k1, "launches": counts[key],
        }
        ok = ok and err <= tol and tuple(res.shape) == (nh, nw * c)
        entries.append({
            "name": key, "route": "cuda", "source": SOURCES[key], "replaces": KERNELS[key],
            "launches": counts[key], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
        })
    exact = make_avir_executor(plan, precision="exact", device=dev)
    report.update({
        "ptxas": _ptxas("planar", "planar"),
        "deinterleave_ms": _time_ms(lambda: pk.deinterleave(x, sh, sw, c, hp, wp), 10, flush),
        "k7_plus_deinterleave_ms": _time_ms(
            lambda: pk.apply_planar(k7, pk.deinterleave(x, sh, sw, c, hp, wp)), 10, flush),
        "k1_split_ms": _time_ms(lambda: fs.apply_fused_split(k1, x), 10, flush),
        "k1_split_variant": k1_key,
        "exact_route_ms": _time_ms(lambda: exact(x), 3, flush),
        "k7_vs_k8_max_abs_diff": int((res7.int() - res8.int()).abs().max()),
        "planar_viable_tpu_budget": pk.planar_viable(vop, pop),
        "planar2_viable_tpu_budget": p2.planar2_viable(vop, pop, c),
        "h_operator": list(pop.taps_hi.shape), "v_operator": list(vop.taps_hi.shape),
        "card": smi,
    })
    print(json.dumps(report))
    if not ok:
        _fail(f"{name}: report {report}")
    return entries


# The public API beyond resize: resize_batch through pinned
# staging, make_resize_fn on a CUDA tensor, errdiff-device on K4, the CLI.
API_BATCH_SHAPES = (
    # (name, src_w, src_h, new_w, new_h, frames, in dtype, res_bit_depth,
    #  K1 launch key, LancIR frames, into a caller's out=)
    ("batch_1080p_to_4k", 1920, 1080, 3840, 2160, 8, np.uint8, 8,
     "fused_int8_hv", 0, False),
    ("batch_8k_to_1080p", 7680, 4320, 1920, 1080, 4, np.uint8, 8,
     "fused_int8_vh", 2, False),
    ("batch_1080p_to_4k_u16_out", 1920, 1080, 3840, 2160, 4, np.uint16, 16,
     "fused_split_vh", 0, True),
)
# PERF.md §5 (measured on one H100): the u16 upsize's d2h into fresh host
# pages, the figure batch_1080p_to_4k_u16_out's reused pages answer.
U16_FRESH_D2H_MS = 37.94
# (name, src_w, src_h, new_w, new_h) of the other API phases.
DEVICE_FN_SHAPE = ("device_fn_8k_to_1080p", 7680, 4320, 1920, 1080)
ERRDIFF_DEVICE_SHAPE = ("errdiff_device_720p_to_1080p", 1280, 720, 1920, 1080)
CLI_SHAPE = ("cli_1080p_to_4k", 1920, 1080, 3840, 2160)


def _host_ms(fn, n: int = 3) -> float:
    """Median host wall ms of fn()."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def _trace(fn) -> dict:
    """Device timeline of one fn() from torch.profiler: kernels and copies,
    their busy time, the span from the first device event to the last, the
    idle share of that span, and the gaps between consecutive kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [
        e for e in prof.events()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    if not evs:
        return {"trace": "not measured: the profiler recorded no device events"}
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in evs)
    copies = [x for x in spans if "memcpy" in x[2].lower()]
    kernels = [x for x in spans if "memcpy" not in x[2].lower()
               and "memset" not in x[2].lower()]
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0, _ in spans:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    gaps = [b[0] - a[1] for a, b in zip(kernels, kernels[1:])]
    return {
        "device_span_ms": span / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / span if span else None,
        "kernels": len(kernels),
        "kernel_ms": sum(e - s0 for s0, e, _ in kernels) / 1e3,
        "copies": len(copies),
        "copy_ms": sum(e - s0 for s0, e, _ in copies) / 1e3,
        "kernel_gap_ms_mean": (sum(gaps) / len(gaps) / 1e3) if gaps else None,
        "kernel_gap_ms_max": (max(gaps) / 1e3) if gaps else None,
    }


def _staging_copies(frame: np.ndarray, dev_out: torch.Tensor, flush) -> dict:
    """Per-frame copies through pinned buffers of the batch staging's
    shapes (device ms, CUDA events), beside the pageable copies of resize,
    and the host memcpys into and out of the pinned buffers (host ms)."""
    pin_in = torch.empty(frame.shape, dtype=torch.from_numpy(frame[:1, :1]).dtype,
                         pin_memory=True)
    pin_out = torch.empty(dev_out.shape, dtype=dev_out.dtype, pin_memory=True)
    d_in = torch.empty(frame.shape, dtype=pin_in.dtype, device=dev_out.device)
    host_out = np.empty(dev_out.shape, dtype=pin_out.numpy().dtype)
    src_t = torch.from_numpy(frame)
    return {
        "h2d_pinned_ms": _time_ms(lambda: d_in.copy_(pin_in, non_blocking=True), 5, flush),
        "d2h_pinned_ms": _time_ms(lambda: pin_out.copy_(dev_out, non_blocking=True), 5, flush),
        "h2d_pageable_ms": _time_ms(lambda: src_t.to(dev_out.device), 5, flush),
        "d2h_pageable_ms": _time_ms(dev_out.cpu, 5, flush),
        "host_into_pinned_ms": _host_ms(lambda: pin_in.copy_(src_t)),
        "host_out_of_pinned_ms": _host_ms(
            lambda: torch.from_numpy(host_out).copy_(pin_out)
        ),
    }


def _batch_phase(name, sw, sh, nw, nh, n, in_dt, bits, kname, lancir_n,
                 use_out, gen, dev, flush, smi, mods) -> None:
    """resize_batch of n frames: each frame bit-equal to resize of that
    frame, K1 launched once per frame, the wall per frame beside the single
    resize's, the pinned copies per frame, and the batch's device trace;
    LancIR.resize_batch of lancir_n frames alike."""
    import avir_tpu_torch
    from avir_tpu_torch.utils.benchmarking import wall_ms

    frames = gen.integers(0, np.iinfo(in_dt).max + 1, (n, sh, sw, 3), dtype=in_dt)
    rz = avir_tpu_torch.ImageResizer(res_bit_depth=bits)
    rz.resize(frames[0], nw, nh)  # executor built, kernels loaded
    out = np.empty((n, nh, nw, 3), dtype=in_dt) if use_out else None
    _zero(mods)
    t0 = time.perf_counter()
    got = rz.resize_batch(frames, nw, nh, out=out)
    first_s = time.perf_counter() - t0
    counts = _counts(mods)
    print(json.dumps({"main_path": name, "launches": counts}))
    if counts[kname] != n or sum(counts.values()) != n:
        _fail(f"{name}: {kname} was not launched once per frame: {counts}")
    singles, single_walls = [], []
    for f in frames:
        t0 = time.perf_counter()
        singles.append(rz.resize(f, nw, nh))
        single_walls.append(1e3 * (time.perf_counter() - t0))
    equal = [bool(np.array_equal(got[i], singles[i])) for i in range(n)]
    batch_ms = wall_ms(lambda: rz.resize_batch(frames, nw, nh, out=out), n=3)
    # The same batch into pages already written (the first result): a
    # result without out= lands in fresh pages the copies fault in.
    reused_ms = wall_ms(lambda: rz.resize_batch(frames, nw, nh, out=got), n=3)
    x = torch.from_numpy(frames[0].reshape(sh, -1)).to(dev)
    y = rz._route(sh, sw, 3, np.dtype(in_dt), nw, nh, device=dev).fn(x)
    report = {
        "shape": name, "frames": n, "kernel": kname,
        "frames_bit_equal_to_resize": f"{sum(equal)}/{n}",
        "out_is_callers": bool(out is None or got is out),
        "batch_first_call_s": first_s,
        "batch_wall_ms_per_frame": batch_ms / n,
        "batch_into_reused_out_wall_ms_per_frame": reused_ms / n,
        "single_resize_wall_ms": sorted(single_walls)[n // 2],
        **_staging_copies(frames[0], y, flush),
        "batch_trace": _trace(lambda: rz.resize_batch(frames, nw, nh, out=out)),
        "card": smi,
    }
    if use_out:
        report["d2h_fresh_pages_ref_ms"] = U16_FRESH_D2H_MS
    ok = all(equal) and report["out_is_callers"]
    if lancir_n:
        lz = avir_tpu_torch.LancIR()
        lf = frames[:lancir_n]
        lz.resize(lf[0], nw, nh)
        _zero(mods)
        lgot = lz.resize_batch(lf, nw, nh)
        lcounts = _counts(mods)
        lequal = [bool(np.array_equal(lgot[i], lz.resize(lf[i], nw, nh)))
                  for i in range(lancir_n)]
        lms = wall_ms(lambda: lz.resize_batch(lf, nw, nh), n=3)
        lsingle = _host_ms(lambda: lz.resize(lf[0], nw, nh))
        report["lancir"] = {
            "frames": lancir_n, "launches": lcounts,
            "frames_bit_equal_to_resize": f"{sum(lequal)}/{lancir_n}",
            "batch_wall_ms_per_frame": lms / lancir_n,
            "single_resize_wall_ms": lsingle,
        }
        ok = ok and all(lequal) and lcounts["fused_int8_vh_even"] == lancir_n \
            and sum(lcounts.values()) == lancir_n
    print(json.dumps(report))
    if not ok:
        _fail(f"{name}: report {report}")


def _device_fn_phase(gen, dev, flush, smi, mods) -> None:
    """make_resize_fn at 8K -> 1080p u8 RGB on a CUDA tensor: a CUDA tensor
    out, one K1 launch, resize's bits; ms per call beside the kernel's."""
    import avir_tpu_torch
    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.utils.benchmarking import device_ms, wall_ms

    name, sw, sh, nw, nh = DEVICE_FN_SHAPE
    src = gen.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
    fn = avir_tpu_torch.make_resize_fn((sh, sw, 3), np.uint8, nw, nh, flat=True)
    x = torch.from_numpy(src.reshape(sh, -1)).to(dev)
    fn(x)
    torch.cuda.synchronize()
    _zero(mods)
    y = fn(x)
    torch.cuda.synchronize()
    counts = _counts(mods)
    print(json.dumps({"main_path": name, "launches": counts}))
    if counts["fused_int8_vh"] != 1 or sum(counts.values()) != 1:
        _fail(f"{name}: fused_int8_vh was not launched once: {counts}")
    want = avir_tpu_torch.resize(src, nw, nh)
    same = bool(np.array_equal(y.cpu().numpy().reshape(nh, nw, 3), want))
    ops = fn.run.ops
    call_ms, breakdown = device_ms(fn, x, n=20)
    kernel_ms, _ = device_ms(lambda t: fk.apply_fused_int8(ops, t), x, n=20)
    report = {
        "shape": name, "output_is_cuda": bool(y.is_cuda), "bit_equal_to_resize": same,
        "call_device_ms": call_ms, "kernel_device_ms": kernel_ms,
        "call_host_wall_ms": wall_ms(fn, x, n=10),
        "kernel_ms_l2_flushed": _time_ms(lambda: fk.apply_fused_int8(ops, x), 20, flush),
        "profiler_breakdown_ms": breakdown,
        "card": smi,
    }
    print(json.dumps(report))
    if not (same and y.is_cuda):
        _fail(f"{name}: report {report}")


def _errdiff_device_phase(gen, dev, flush, smi, mods) -> None:
    """dither="errdiff-device" at 720p -> 1080p u8 RGB: one K4 launch in the
    sequential scan's sum order, bit-equal to its plain version on the same
    pre-dither image; beside dither="errdiff" (the wavefront's order) with
    the pixels where the two differ."""
    import avir_tpu_torch
    from avir_tpu_torch.models.runtime import make_avir_executor
    from avir_tpu_torch.ops.cuda import wavefront as wf
    from avir_tpu_torch.plan.plan import build_resize_plan

    name, sw, sh, nw, nh = ERRDIFF_DEVICE_SHAPE
    src = gen.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
    rz = avir_tpu_torch.ImageResizer()
    rz.resize(src, nw, nh, dither="errdiff-device")
    _zero(mods)
    got = rz.resize(src, nw, nh, dither="errdiff-device")
    counts = _counts(mods)
    print(json.dumps({"main_path": name, "launches": counts}))
    if counts["wavefront"] != 1:
        _fail(f"{name}: K4 was not launched once: {counts}")
    plan = build_resize_plan(sw, sh, nw, nh, 3, np.uint8, np.uint8)
    pre = make_avir_executor(plan, device=dev, return_predither=True)(
        torch.from_numpy(src.reshape(sh, -1)).to(dev)
    ).reshape(nh, nw, 3)
    q = wf.errdiff_wavefront(pre, 0, 255.0, out_dtype=torch.uint8, scan_order=True)
    plain = wf.errdiff_wavefront_reference(pre, 0, 255.0, scan_order=True).to(torch.uint8)
    torch.cuda.synchronize()
    k4_equal = bool(torch.equal(q, plain))
    same = bool(np.array_equal(q.cpu().numpy(), got))
    wav = rz.resize(src, nw, nh, dither="errdiff")
    diff = np.abs(got.astype(np.int16) - wav.astype(np.int16))
    report = {
        "shape": name, "k4_scan_order_bit_equal_to_plain": k4_equal,
        "resize_equals_k4": same,
        "pixels_differing_from_errdiff": int((diff > 0).sum()),
        "max_diff_from_errdiff": int(diff.max()),
        "k4_scan_order_ms": _time_ms(
            lambda: wf.errdiff_wavefront(pre, 0, 255.0, out_dtype=torch.uint8,
                                         scan_order=True), 10, flush),
        "k4_wavefront_order_ms": _time_ms(
            lambda: wf.errdiff_wavefront(pre, 0, 255.0, out_dtype=torch.uint8),
            10, flush),
        "resize_wall_ms": _host_ms(
            lambda: rz.resize(src, nw, nh, dither="errdiff-device"), 5),
        "card": smi,
    }
    print(json.dumps(report))
    if not (k4_equal and same and diff.max() <= 1):
        _fail(f"{name}: report {report}")


def _cli_phase(gen, smi, mods) -> None:
    """The CLI on the card: a 1080p PNG written by the native binding,
    resized to 4K; the output PNG decodes to resize's bits."""
    import pathlib

    import avir_tpu_torch
    from avir_tpu_torch import cli, native

    name, sw, sh, nw, nh = CLI_SHAPE
    if not native.have_native():
        _fail(f"{name}: the native binding did not load (and could not be built)")
    d = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    d.mkdir(parents=True, exist_ok=True)
    src = gen.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
    inp, outp = d / "in.png", d / "out.png"
    t0 = time.perf_counter()
    inp.write_bytes(native.png_encode(src))
    encode_s = time.perf_counter() - t0
    _zero(mods)
    t0 = time.perf_counter()
    rc = cli.main([str(inp), str(outp), f"--out-size={nw}x{nh}"])
    cli_s = time.perf_counter() - t0
    counts = _counts(mods)
    print(json.dumps({"main_path": name, "launches": counts}))
    if rc != 0 or counts["fused_int8_hv"] != 1 or sum(counts.values()) != 1:
        _fail(f"{name}: rc {rc}, launches {counts}")
    dec = native.png_decode(outp.read_bytes())
    same = bool(np.array_equal(dec, avir_tpu_torch.resize(src, nw, nh)))
    report = {
        "shape": name, "decoded_equals_resize": same,
        "native_library": str(native.library_path().relative_to(d.parents[1])),
        "png_encode_s": encode_s, "cli_call_s": cli_s, "card": smi,
    }
    print(json.dumps(report))
    if not same:
        _fail(f"{name}: report {report}")


# ---- the row-strip mesh (avir_tpu_torch/parallel/) ----------------------

MESH_CASES = (
    # (name, entry, src_w, src_h, new_w, new_h, frames, dp, sp, executor
    #  kwargs, the K1 launch key of each strip (None: the library route),
    #  the case whose assembled bits it must equal)
    ("mesh_8k_to_1080p_sp4", "avir", 7680, 4320, 1920, 1080, 0, 1, 4, {},
     "fused_int8_vh", None),
    ("mesh_1080p_to_4k_dp2_sp2", "avir", 1920, 1080, 3840, 2160, 4, 2, 2, {},
     "fused_int8_vh", None),
    ("mesh_720p_to_1080p_errdiff_sp4", "avir", 1280, 720, 1920, 1080, 0, 1, 4,
     {"dither": "errdiff"}, "fused_split_vh", None),
    ("mesh_lancir_8k_to_1080p_sp4", "lancir", 7680, 4320, 1920, 1080, 0, 1, 4,
     {}, "fused_int8_vh_even", None),
    # An extreme downsize on small strips: the all-gather fallback (the
    # library route), with a rank that owns only padding rows.
    ("mesh_all_gather_sp4", "avir", 640, 16, 320, 5, 0, 1, 4, {}, None, None),
    ("mesh_8k_to_1080p_sp4_overlap", "avir", 7680, 4320, 1920, 1080, 0, 1, 4,
     {"halo_overlap": True}, "fused_int8_vh", "mesh_8k_to_1080p_sp4"),
)
MESH_WORLD = 4          # gloo processes sharing the one card
MESH_JOIN_S = 600       # the most a world may take before it is killed
MESH_INIT_S = 120       # rendezvous and collective timeout
MESH_TIMED = 10         # launches / exchanges per timing


def _mesh_src_file(root, case):
    return root / f"{case[0]}_src.npy"


def _mesh_inputs(root, cases, gen, main_src, main_oracle) -> None:
    """The mesh cases' inputs ([frames, H, W*3] or [H, W*3] u8), the port's
    single-card result of each (the public entry points on the card) and,
    for the 8K case, the float64 oracle of the main path's 8K image."""
    import avir_tpu_torch

    root.mkdir(parents=True, exist_ok=True)
    for case in cases:
        name, entry, sw, sh, nw, nh, frames = case[:7]
        shape = ((frames,) if frames else ()) + (sh, sw, 3)
        if (sw, sh, frames) == (7680, 4320, 0):
            src = main_src
        else:
            src = gen.integers(0, 256, shape, dtype=np.uint8)
        np.save(_mesh_src_file(root, case), src.reshape(*shape[:-3], sh, sw * 3))
        kw = case[9]
        one = (
            (lambda im: avir_tpu_torch.resize(im, nw, nh, dither=kw.get("dither", "default")))
            if entry == "avir" else (lambda im: avir_tpu_torch.lancir_resize(im, nw, nh))
        )
        single = np.stack([one(im) for im in src]) if frames else one(src)
        np.save(root / f"{name}_single.npy", single.reshape(*single.shape[:-3], nh, nw * 3))
    np.save(root / "mesh_8k_to_1080p_sp4_oracle.npy", main_oracle.reshape(len(main_oracle), -1))


def _mesh_case(case, mesh, root, backend: str, world: int, done: dict) -> None:
    """One case on one rank: drive the executor with the launch counts set
    to 0 just before and read just after; hold each K1 launch of the
    rank's strip body to its plain version; time the strip's kernels, the
    halo exchange and the executor's own gather; and on rank 0 check the
    assembled image."""
    import torch.distributed as dist

    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.ops.cuda import fused_split as fs
    from avir_tpu_torch.ops.cuda import wavefront as wf
    from avir_tpu_torch.parallel import comm, sharded
    from avir_tpu_torch.plan.lancir_plan import build_lancir_plan
    from avir_tpu_torch.plan.plan import build_resize_plan

    name, entry, sw, sh, nw, nh, frames, _, sp, kw, key, twin = case
    mods = (fk, fs, wf)
    rank = dist.get_rank()
    build = build_resize_plan if entry == "avir" else build_lancir_plan
    plan = build(sw, sh, nw, nh, 3, np.uint8, np.uint8)
    make = (
        sharded.make_sharded_avir_executor if entry == "avir"
        else sharded.make_sharded_lancir_executor
    )
    fn = make(plan, mesh, **kw)
    flat = sharded.pad_rows(np.load(_mesh_src_file(root, case), mmap_mode="r"), sp)
    x = torch.from_numpy(np.array(sharded.local_strip(mesh, flat))).to(mesh.device)
    torch.cuda.synchronize()
    dist.barrier()
    _zero(mods)
    t0 = time.perf_counter()
    y = fn(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {k: v for k, v in _counts(mods).items() if v}
    n_local = frames // mesh.dp if frames else 1
    want = {}
    if key is not None:
        want[key] = n_local * len(fn.strip.parts)
    if "dither" in kw:
        want["wavefront"] = n_local
    if counts != want:
        raise RuntimeError(f"{name} rank {rank}: launches {counts}, expected {want}")
    sv = fn.svop
    report = {
        "mesh_case": name, "backend": backend, "world": world, "rank": rank,
        "route": fn.route, "launches": counts, "strip_rows": sv.strip,
        "halo_lo": sv.halo_lo, "halo_hi": sv.halo_hi, "first_call_s": first_s,
    }
    # As the main path flushes: the 256 MB zeroing also covers the host's
    # launch preparation, which would otherwise sit inside the events.
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=mesh.device)
    if fn.strip is not None:
        # The rank's first frame, its halos cut from the whole input.
        frame = torch.from_numpy(np.array(flat[mesh.dp_index * n_local] if frames else flat))
        xf = frame[mesh.sp_index * sv.strip : (mesh.sp_index + 1) * sv.strip].to(mesh.device)
        h_lo, h_hi = (h.to(mesh.device) for h in sharded.halo_rows(frame, sv, mesh.sp_index))
        ext = fn.strip.ext(xf, h_lo, h_hi)
        errs = [
            _mesh_vs_plain(fn.route, ops, ext if on_ext else xf, f"{name} rank {rank}")
            for ops, on_ext in fn.strip.parts
        ]
        dist.barrier()
        report["max_abs_err_vs_plain"] = max(errs)
        report["strip_kernel_ms"] = _time_ms(
            lambda: [sharded._k1(ops, ext if on_ext else xf) for ops, on_ext in fn.strip.parts],
            MESH_TIMED, flush,
        )
        report["ext_rows"] = fn.strip.ext_rows
    # The halo exchange on this rank's strips (all its frames), and the
    # executor's own gather: the pre-dither float32 rows for errdiff, the
    # H-passed float32 strip for the all-gather fallback.
    if not sv.use_all_gather:
        report["halo_ms"], (h_lo, h_hi) = _collective_ms(lambda: comm.exchange_halos(x, sv, mesh.sp_group))
        report["halo_bytes_received"] = (h_lo.numel() + h_hi.numel()) * x.element_size()
    gathered = None
    if "dither" in kw:
        gathered = torch.zeros((n_local, sv.m, nw * 3), dtype=torch.float32, device=mesh.device)
    elif sv.use_all_gather:
        gathered = torch.zeros((sv.strip, nw * 3), dtype=torch.float32, device=mesh.device)
    if gathered is not None:
        report["gather_ms"], _ = _collective_ms(lambda: comm.all_gather_rows(gathered, mesh.sp_group))
        report["gather_bytes_sent"] = gathered.numel() * 4
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    report["step_ms"] = 1e3 * (time.perf_counter() - t0) / 3
    full = sharded.assemble(mesh, y, nh)
    if rank == 0:
        _check_assembled(name, full.cpu().numpy(), 3, root, done, twin, report)
    print(json.dumps(report), flush=True)


def _mesh_vs_plain(route: str, ops, inp: torch.Tensor, where: str) -> float:
    """One K1 launch of a rank's body against its plain version on the
    same input: int8 bit-equal, split within the split gate."""
    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.ops.cuda import fused_split as fs

    if route == "int8":
        got, plain = fk.apply_fused_int8(ops, inp), fk.apply_fused_int8_reference(ops, inp)
        err, tol = int((got.int() - plain.int()).abs().max()), 0
    else:
        got, plain = fs.apply_fused_split(ops, inp), fs.apply_fused_split_reference(ops, inp)
        err = float((got.double() - plain.double()).abs().max())
        tol = float(plain.abs().max()) * 1e-4 if got.dtype == torch.float32 else 1.0
    if not err <= tol:
        raise RuntimeError(f"{where}: kernel vs plain {err} > {tol}")
    return err


def _collective_ms(fn) -> tuple:
    """(host ms per call, last result) of a collective ``fn`` that every
    rank calls MESH_TIMED times after a barrier, ending synchronized."""
    import torch.distributed as dist

    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(MESH_TIMED):
        out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / MESH_TIMED, out


def _check_assembled(name, got: np.ndarray, c: int, root, done: dict, twin, report: dict) -> None:
    """Rank 0's checks of a mesh case's assembled image: within 1 LSB of
    the single card's (with the pixels that differ), within 1 LSB and
    >= 60 dB of the float64 oracle where there is one, and bit-equal to
    ``twin``'s image where one is named; the figures go into ``report``."""
    single = np.load(root / f"{name}_single.npy")
    diff = np.abs(got.astype(np.int16) - single.astype(np.int16))
    report["shape"] = list(got.shape)
    report["max_lsb_vs_single_card"] = int(diff.max())
    report["pixels_differing_from_single_card"] = int(
        diff.reshape(*diff.shape[:-1], -1, c).any(axis=-1).sum()
    )
    report["pixels"] = int(np.prod(got.shape) // c)
    ok = got.shape == single.shape and diff.max() <= 1
    oracle = root / f"{name}_oracle.npy"
    if oracle.exists():
        o = np.load(oracle)
        report["max_lsb_vs_f64_oracle"] = int(np.abs(got.astype(np.int16) - o.astype(np.int16)).max())
        report["psnr_vs_f64_oracle_db"] = _psnr(got, o)
        ok = ok and report["max_lsb_vs_f64_oracle"] <= 1 and report["psnr_vs_f64_oracle_db"] >= 60.0
    if twin is not None:
        report["bit_equal_to"] = {twin: bool(np.array_equal(got, done[twin]))}
        ok = ok and report["bit_equal_to"][twin]
    done[name] = got
    if not ok:
        raise RuntimeError(f"{name}: assembled image failed its checks: {report}")


def _mesh_worker(rank: int, world: int, backend: str, init: str, cases, root: str,
                 two_d: bool = False) -> None:
    """One rank of a mesh world (torch.multiprocessing.spawn's target), on
    the row-strip mesh or with ``two_d`` the 2-D one: gloo ranks share
    card 0, NCCL ranks take one card each."""
    import datetime
    import pathlib

    import torch.distributed as dist

    torch.cuda.set_device(0 if backend == "gloo" else rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from avir_tpu_torch.parallel import multihost

    multihost.initialize(
        backend, init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=MESH_INIT_S),
    )
    try:
        meshes, done = {}, {}
        for case in cases:
            grid = case[9][1:] if two_d else case[7:9]
            if grid not in meshes:
                # device=None: the mesh's default, cuda:(local rank % cards).
                meshes[grid] = (
                    multihost.make_dp_sp_cp_mesh(*grid) if two_d
                    else multihost.make_dp_sp_mesh(sp=grid[1])
                )
            (_mesh2d_case if two_d else _mesh_case)(
                case, meshes[grid], pathlib.Path(root), backend, world, done
            )
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_world(backend: str, world: int, cases, root, two_d: bool = False) -> float:
    """Run ``cases`` on a world of ``world`` spawned processes (on the 2-D
    mesh with ``two_d``); a worker's failure (or the time limit) fails the
    script.  Returns seconds."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.spawn(
        _mesh_worker,
        args=(world, backend, f"tcp://127.0.0.1:{_free_port()}", cases, str(root), two_d),
        nprocs=world, join=False,
    )
    while not ctx.join(timeout=5):
        if time.perf_counter() - t0 > MESH_JOIN_S:
            for p in ctx.processes:
                p.kill()
            _fail(f"mesh world ({backend} x {world}) exceeded {MESH_JOIN_S} s")
    return time.perf_counter() - t0


def _launch_overhead_us(dev) -> float:
    """Device us per K1 int8 launch on a tiny strip (64x32 -> 32x16 u8
    RGB), CUDA events around 200 back-to-back launches: the per-launch
    overhead the scaling model's T_DISPATCH stands for."""
    from avir_tpu_torch.models.runtime import make_avir_executor
    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.plan.plan import build_resize_plan

    ops = make_avir_executor(build_resize_plan(64, 32, 32, 16, 3, np.uint8, np.uint8), device=dev).ops
    x = torch.zeros((32, 64 * 3), dtype=torch.uint8, device=dev)
    for _ in range(10):
        fk.apply_fused_int8(ops, x)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(200):
        fk.apply_fused_int8(ops, x)
    e1.record()
    e1.synchronize()
    return 1e3 * e0.elapsed_time(e1) / 200


def _mesh_phase(gen, dev, smi, main_src, main_oracle, t_chip_ms: float) -> tuple:
    """The row-strip mesh: world A, 4 gloo processes time-sharing the one
    card (every case); world B, NCCL with one process (the 8K case), and
    with two cards or more NCCL over min(cards, 4) processes (the 8K case
    and, on four, the dp x sp batch).  Then the launch overhead and the
    scaling model's table (a model: data-sheet links, this run's K1 time)."""
    import pathlib

    from avir_tpu_torch.parallel import scaling_model
    from avir_tpu_torch.plan.plan import build_resize_plan

    root = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_mesh"
    t0 = time.perf_counter()
    _mesh_inputs(root, MESH_CASES, gen, main_src, main_oracle)
    prep_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    worlds = {"gloo x4": _mesh_world("gloo", MESH_WORLD, MESH_CASES, root)}
    (case_a,) = [c for c in MESH_CASES if c[0] == "mesh_8k_to_1080p_sp4"]
    one = case_a[:8] + (1,) + case_a[9:]
    worlds["nccl x1"] = _mesh_world("nccl", 1, (one,), root)
    cards = torch.cuda.device_count()
    if cards >= 2:
        n = min(cards, 4)
        cases = [case_a[:8] + (n,) + case_a[9:]]
        if n == 4:
            cases += [c for c in MESH_CASES if c[0] == "mesh_1080p_to_4k_dp2_sp2"]
        worlds[f"nccl x{n}"] = _mesh_world("nccl", n, tuple(cases), root)
    overhead = _launch_overhead_us(dev)
    plan = build_resize_plan(7680, 4320, 1920, 1080, 3, np.uint8, np.uint8)
    pts = scaling_model.model_scaling(
        plan, t_chip_ms * 1e-3, n_devs=(2, 4, 8), t_dispatch=overhead * 1e-6
    )
    print(scaling_model.format_table(pts))
    print(json.dumps({
        "mesh_phase": {"inputs_s": prep_s, "worlds_s": worlds},
        "launch_overhead_us": overhead,
        "scaling_model_8k_to_1080p": {
            "note": "a model: NVLink 4 data-sheet links, this run's whole-image K1 ms",
            "t_chip_ms": t_chip_ms,
            "points": [dataclasses.asdict(p) for p in pts],
        },
        "card": smi,
        "label": "world A: four processes time-share one card and gloo copies "
                 "halos through the host; not a scaling figure",
    }))
    return overhead, pts


# ---- the 2-D (rows x cols) mesh (avir_tpu_torch/parallel/, 2-D half) ---

MESH2D_CASES = (
    # (name, entry, src_w, src_h, new_w, new_h, c, plan kwargs, frames,
    #  (dp, sp, cp), executor kwargs, the K1 launch key of each tile, the
    #  case whose assembled bits it must equal)
    # suggest_grid's choice at n = 4 (pure columns).
    ("mesh2d_8k_to_1080p_1x4", "avir", 7680, 4320, 1920, 1080, 3, {}, 0, (1, 1, 4), {},
     "fused_int8_vh", None),
    ("mesh2d_8k_to_1080p_2x2", "avir", 7680, 4320, 1920, 1080, 3, {}, 0, (1, 2, 2), {},
     "fused_int8_vh", None),
    ("mesh2d_8k_to_1080p_2x2_overlap", "avir", 7680, 4320, 1920, 1080, 3, {}, 0, (1, 2, 2),
     {"halo_overlap": True}, "fused_int8_vh", "mesh2d_8k_to_1080p_2x2"),
    ("mesh2d_lancir_8k_to_1080p_2x2", "lancir", 7680, 4320, 1920, 1080, 3, {}, 0, (1, 2, 2), {},
     "fused_int8_vh_even", None),
    ("mesh2d_720p_to_1080p_errdiff_2x2", "avir", 1280, 720, 1920, 1080, 3, {}, 0, (1, 2, 2),
     {"dither": "errdiff"}, "fused_split_vh", None),
    # Odd shapes: the C = 4 alpha bypass on tiles of gamma RGBA, and u8 RGB
    # tiles whose lanes are no multiple of 16 (K1's narrow loads).
    ("mesh2d_gamma_rgba_odd_2x2", "avir", 70, 90, 50, 62, 4,
     {"use_srgb_gamma": True, "alpha_index": 3}, 0, (1, 2, 2), {}, "fused_int8_vh_gamma", None),
    ("mesh2d_odd_u8_1x4", "avir", 70, 90, 50, 62, 3, {}, 0, (1, 1, 4), {}, "fused_int8_vh", None),
)
# Grids whose every rank's Tile.compute is timed alone on the one card at
# 8K -> 1080p, for the scaling model's measured compute term.
MESH2D_ALONE_GRIDS = ((1, 2), (1, 4), (2, 2), (4, 1))


def _mesh2d_src_file(root, case):
    return root / f"mesh2d_{case[2]}x{case[3]}x{case[6]}_{case[9][1]}x{case[9][2]}_src.npy"


def _mesh2d_plan(case):
    from avir_tpu_torch.plan.lancir_plan import build_lancir_plan
    from avir_tpu_torch.plan.plan import build_resize_plan

    _, entry, sw, sh, nw, nh, c, plan_kw = case[:8]
    build = build_resize_plan if entry == "avir" else build_lancir_plan
    return build(sw, sh, nw, nh, c, np.uint8, np.uint8, **plan_kw)


def _mesh2d_inputs(root, cases, gen, main_src, main_oracle) -> None:
    """The 2-D cases' padded inputs ([H_pad, W_pad*C] u8), the port's
    single-card result of each (the public entry points on the card) and,
    for 8K -> 1080p on 1 x 4 and as one tile, the float64 oracle."""
    import avir_tpu_torch
    from avir_tpu_torch.parallel import sharded

    root.mkdir(parents=True, exist_ok=True)
    srcs = {(7680, 4320, 3): main_src}
    for case in cases:
        name, entry, sw, sh, nw, nh, c, plan_kw, _, (_, sp, cp), kw = case[:11]
        if (sw, sh, c) not in srcs:
            srcs[sw, sh, c] = gen.integers(0, 256, (sh, sw, c), dtype=np.uint8)
        src = srcs[sw, sh, c]
        path = _mesh2d_src_file(root, case)
        if not path.exists():
            np.save(path, sharded.pad_cols(sharded.pad_rows(src.reshape(sh, sw * c), sp), cp, c))
        if entry == "avir":
            single = avir_tpu_torch.resize(src, nw, nh, dither=kw.get("dither", "default"), **plan_kw)
        else:
            single = avir_tpu_torch.lancir_resize(src, nw, nh)
        np.save(root / f"{name}_single.npy", single.reshape(nh, nw * c))
    for name in ("mesh2d_8k_to_1080p_1x4", "mesh2d_8k_to_1080p_1x1"):
        np.save(root / f"{name}_oracle.npy", main_oracle.reshape(len(main_oracle), -1))


def _mesh2d_case(case, mesh, root, backend: str, world: int, done: dict) -> None:
    """One 2-D case on one rank: drive the executor with the launch counts
    set to 0 just before and read just after; hold each K1 launch of the
    rank's tile body to its plain version on the rank's own tiles; time
    the tile's kernels, the column and row halo exchanges and the
    executor's own gather; and on rank 0 check the assembled image."""
    import torch.distributed as dist

    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.ops.cuda import fused_split as fs
    from avir_tpu_torch.ops.cuda import wavefront as wf
    from avir_tpu_torch.parallel import comm, sharded

    name, entry, sw, sh, nw, nh, c, _, frames, _, kw, key, twin = case
    mods = (fk, fs, wf)
    rank, i, j = dist.get_rank(), mesh.sp_index, mesh.cp_index
    plan = _mesh2d_plan(case)
    make = (
        sharded.make_sharded_avir_executor_2d if entry == "avir"
        else sharded.make_sharded_lancir_executor_2d
    )
    fn = make(plan, mesh, **kw)
    flat = np.load(_mesh2d_src_file(root, case), mmap_mode="r")
    x = torch.from_numpy(np.array(sharded.local_tile(mesh, flat))).to(mesh.device)
    torch.cuda.synchronize()
    dist.barrier()
    _zero(mods)
    t0 = time.perf_counter()
    y = fn(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {k: v for k, v in _counts(mods).items() if v}
    want = {key: len(fn.tile.parts)}
    if "dither" in kw:
        want["wavefront"] = 1
    if counts != want:
        raise RuntimeError(f"{name} rank {rank}: launches {counts}, expected {want}")
    sv, sl = fn.svop, fn.slb
    report = {
        "mesh2d_case": name, "backend": backend, "world": world, "rank": rank,
        "tile": [i, j], "route": fn.route, "launches": counts, "tile_shape": list(x.shape),
        "row_halos": [sv.halo_lo, sv.halo_hi], "col_halo_lanes": [sl.halo_lo, sl.halo_hi],
        "first_call_s": first_s,
    }
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=mesh.device)
    tiles = {
        on: torch.from_numpy(np.array(t)).to(mesh.device)
        for on, t in zip(("x", "xc", "ext"), sharded.halo_tiles(np.asarray(flat), sv, sl, i, j))
    }
    errs, parts = [], []
    for ops, on in fn.tile.parts:
        errs.append(_mesh_vs_plain(fn.route, ops, tiles[on], f"{name} rank {rank} on {on}"))
        part = {"input": on, "rows_in": ops.rows_in, "lanes_in": ops.lanes_in}
        if getattr(ops, "h_range", None) is not None:
            # Chunks whose lane taps are all zero (output lanes past the
            # rank's pixels), and the tensor-core int8 kernel's load width.
            hr = ops.h_range.cpu().numpy()
            part.update(empty_chunks=int((hr[..., 1] <= hr[..., 0]).sum()), chunks=int(hr[..., 0].size))
        if fn.route == "int8" and not ops.epi.gamma:
            part.update(lane_align=ops.lane_align,
                        wide_loads=bool(ops.lane_align % 16 == 0 and ops.lanes_in % 16 == 0))
        parts.append(part)
    dist.barrier()
    report["max_abs_err_vs_plain"] = max(errs)
    report["parts"] = parts
    report["k1_ms_per_tile"] = _time_ms(
        lambda: fn.tile.compute(tiles["x"], tiles["xc"], tiles["ext"]), MESH_TIMED, flush
    )
    # The two exchanges on this rank's tile, then the executor's gather of
    # the pre-dither float32 tiles (errdiff).
    report["col_halo_ms"], (c_lo, c_hi) = _collective_ms(
        lambda: comm.exchange_col_halos(x, sl, mesh.cp_group)
    )
    report["col_halo_bytes_received"] = (c_lo.numel() + c_hi.numel()) * x.element_size()
    xc = sharded._cat_lanes([c_lo, x, c_hi])
    report["row_halo_ms"], (r_lo, r_hi) = _collective_ms(lambda: comm.exchange_halos(xc, sv, mesh.sp_group))
    report["row_halo_bytes_received"] = (r_lo.numel() + r_hi.numel()) * x.element_size()
    if "dither" in kw:
        z = torch.zeros((1, sv.m, sl.m * c), dtype=torch.float32, device=mesh.device)
        report["gather_ms"], _ = _collective_ms(lambda: comm.all_gather_tiles(z, mesh.cp_group, mesh.sp_group))
        report["gather_bytes_sent"] = z.numel() * 4
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    report["step_ms"] = 1e3 * (time.perf_counter() - t0) / 3
    full = sharded.assemble_2d(mesh, y, nh, nw * c)
    if rank == 0:
        _check_assembled(name, full.cpu().numpy(), c, root, done, twin, report)
    print(json.dumps(report), flush=True)


def _mesh2d_alone(plan, src, single, grid, dev, flush) -> dict:
    """Every rank's ``Tile.compute`` of an r x s grid alone on the one card
    (tiles and halos cut from the padded image, as tools/probe_strip2d_tpu.py
    does on one TPU there): CUDA-event ms per rank, and the pixels where the
    assembled ranks differ from the single card's ``single``."""
    from avir_tpu_torch.parallel import sharded
    from avir_tpu_torch.parallel.multihost import DpSpCpMesh

    r, s = grid
    sh, sw, c = src.shape
    flat = sharded.pad_cols(sharded.pad_rows(src.reshape(sh, sw * c), r), s, c)
    ms, rows = [], []
    for i in range(r):
        row = []
        for j in range(s):
            mesh = DpSpCpMesh(1, r, s, 0, i, j, None, None, None, dev)
            fn = sharded.make_sharded_avir_executor_2d(plan, mesh)
            tiles = [torch.from_numpy(t).to(dev) for t in sharded.halo_tiles(flat, fn.svop, fn.slb, i, j)]
            row.append(fn.tile.compute(*tiles).cpu().numpy())
            ms.append(_time_ms(lambda: fn.tile.compute(*tiles), MESH_TIMED, flush))
        rows.append(np.concatenate(row, axis=1))
    got = np.concatenate(rows, axis=0)[: plan.new_h, : plan.new_w * c]
    diff = np.abs(got.astype(np.int16) - single.reshape(got.shape).astype(np.int16))
    return {
        "grid": [r, s], "rank_ms": ms, "max_rank_ms": max(ms),
        "pixels_differing_from_single_card": int(diff.reshape(*diff.shape[:-1], -1, c).any(axis=-1).sum()),
        "col_halo_lanes": [fn.slb.halo_lo, fn.slb.halo_hi],
        "row_halos": [fn.svop.halo_lo, fn.svop.halo_hi],
    }


def _mesh2d_phase(gen, dev, smi, main_src, main_oracle, t_chip_ms: float,
                  overhead_us: float, pts_1d) -> None:
    """The 2-D (rows x cols) mesh: world A, 4 gloo processes time-sharing
    the one card (every case of MESH2D_CASES), then NCCL with one process
    on 8K -> 1080p as one tile; then every rank's tile body alone on the
    card at 8K for MESH2D_ALONE_GRIDS, whose slowest rank is the 2-D
    scaling model's compute term (with this run's launch overhead),
    printed beside the 1-D table."""
    import pathlib

    from avir_tpu_torch.parallel import scaling_model, sharded
    from avir_tpu_torch.plan.plan import build_resize_plan

    root = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_mesh2d"
    t0 = time.perf_counter()
    plan = build_resize_plan(7680, 4320, 1920, 1080, 3, np.uint8, np.uint8)
    if sharded.suggest_grid(plan, 4) != (1, 4):
        _fail(f"suggest_grid(8K, 4) = {sharded.suggest_grid(plan, 4)}, expected (1, 4)")
    # 8K -> 1080p as one tile.
    one = ("mesh2d_8k_to_1080p_1x1",) + MESH2D_CASES[0][1:9] + ((1, 1, 1),) + MESH2D_CASES[0][10:]
    _mesh2d_inputs(root, MESH2D_CASES + (one,), gen, main_src, main_oracle)
    prep_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    worlds = {"gloo x4": _mesh_world("gloo", MESH_WORLD, MESH2D_CASES, root, two_d=True)}
    worlds["nccl x1"] = _mesh_world("nccl", 1, (one,), root, two_d=True)
    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    single = np.load(root / "mesh2d_8k_to_1080p_1x4_single.npy")
    alone = [_mesh2d_alone(plan, main_src, single, g, dev, flush) for g in MESH2D_ALONE_GRIDS]
    alone_s = time.perf_counter() - t0
    for a in alone:
        print(json.dumps({"mesh2d_alone_8k_to_1080p": a, "card": smi}))
        if a["pixels_differing_from_single_card"]:
            _fail(f"2-D tiles alone at {a['grid']} differ from the single card")
    t_rank = {tuple(a["grid"]): a["max_rank_ms"] * 1e-3 for a in alone}
    grids = ((1, 2), (2, 1), (1, 4), (2, 2), (4, 1), (1, 8), (2, 4))
    pts = scaling_model.model_scaling_2d(
        plan, t_chip_ms * 1e-3, grids=grids, t_dispatch=overhead_us * 1e-6, t_rank_s=t_rank,
    )
    print(scaling_model.format_table(pts_1d))
    print(scaling_model.format_table_2d(pts))
    print(json.dumps({
        "mesh2d_phase": {"inputs_s": prep_s, "worlds_s": worlds, "alone_s": alone_s},
        "scaling_model_2d_8k_to_1080p": {
            "note": "a model: NVLink 4 data-sheet links and the library route's halos; "
                    "compute measured alone per rank where the grid has a measurement",
            "t_chip_ms": t_chip_ms, "launch_overhead_us": overhead_us,
            "measured_grids": sorted(t_rank),
            "points": [dataclasses.asdict(p) for p in pts],
        },
        "card": smi,
        "label": "world A: four processes time-share one card and gloo copies "
                 "halos through the host; not a scaling figure",
    }))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def kernel_times(root: str) -> int:
    """K1 int8 (no gamma) at its four main-path cells (KT_INT8_CELLS), the
    gamma kernels at KT_GAMMA_CELLS (K6 at the two ring cells; K5 and K1
    int8 from its limb planes, vh and hv, at the two prologue cells; K1
    int8 with the in-kernel gamma at the other three, with its bound, MACs,
    stagings and slice heights), K2 at
    KT_K2_CELLS (the row pass of two unfused errdiff resizes, on K3's
    output, split3 and exact; at the first cell also split2 and exact on
    the u8 image and exact on the image as u16), K3 at KT_K3_CELLS (the lane pass of the three unfused
    resizes, on the image the route gives it), K7 and K8 at
    KT_PLANAR_CELLS (with K1 split of the same resize beside them) and K1
    split hv at KT_SPLIT_HV_CELLS (with K1 split vh beside it), timed
    on the package under ``root`` through the calls that
    the versions being compared share (the executors' operands,
    ``apply_fused_int8``, ``apply_fused_ring``, ``apply_gamma_prologue``,
    ``apply_lanes``, ``apply_banded``, ``apply_planar``, ``apply_planar2``,
    ``apply_fused_split``), so that two versions run in turns
    in one chip call; at the two downsizes also the split route
    (precision="fast", K1 split vh) of the same resize as a yardstick:

        python3 chip_smoke.py --kernel-times DIR

    Prints one JSON line with each time, the largest difference from the
    plain version and a hash of each output (equal hashes: bit-equal
    outputs across the versions; K2, K3, K7 and K8 sum float32 in their
    kernels' order, so their hashes change with their design; K2's and
    K3's gate is max|plain| * 1e-5, K7's, K8's and K1 split's the split
    gate), K1 split hv's, K2 exact's, K3's, K5's, K7's and K8's bounds, K1
    split hv's MACs issued and stagings, K5's load path, and ptxas's
    registers and spills of the fused_int8, planar, fused_split and banded
    libraries built in this call."""
    import hashlib
    import os

    sys.path.insert(0, os.path.abspath(root))
    from avir_tpu_torch.models.runtime import (
        GAMMA_ROUTE_ENV,
        make_avir_executor,
        make_lancir_executor,
    )
    from avir_tpu_torch.ops.cuda import banded_kernel as bk
    from avir_tpu_torch.ops.cuda import build
    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.ops.cuda import fused_ring as fr
    from avir_tpu_torch.ops.cuda import fused_split as fs
    from avir_tpu_torch.ops.cuda import gamma_prologue as gp
    from avir_tpu_torch.ops.cuda import lanes_kernel as lk
    from avir_tpu_torch.ops.cuda import planar as pk
    from avir_tpu_torch.ops.cuda import planar2 as p2
    from avir_tpu_torch.ops.gamma import f32, srgb_to_linear_2d
    from avir_tpu_torch.plan.lancir_plan import build_lancir_plan
    from avir_tpu_torch.plan.plan import build_resize_plan

    built = build.build(["fused_int8", "fused_split", "fused_ring", "gamma_prologue",
                         "banded", "lanes", "planar"])
    BUILD_LOGS.update({name: info["log"] for name, info in built.items()})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    gen = np.random.default_rng(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def sha(t: torch.Tensor) -> str:
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    times = {}
    for name, entry, sw, sh, nw, nh in KT_INT8_CELLS:
        if entry == "lancir":
            plan = build_lancir_plan(sw, sh, nw, nh, 3, np.uint8, np.uint8)
            make = make_lancir_executor
        else:
            plan = build_resize_plan(sw, sh, nw, nh, 3, np.uint8, np.uint8)
            make = make_avir_executor
        ops = make(plan, device=dev).ops
        src = gen.integers(0, 256, (sh, sw * 3), dtype=np.uint8)
        x = torch.from_numpy(src).to(dev)
        got = fk.apply_fused_int8(ops, x)
        want = fk.apply_fused_int8_reference(ops, x)
        cell = {
            "ms": _time_ms(lambda: fk.apply_fused_int8(ops, x), 20, flush),
            "max_abs_err_vs_plain": int((got.int() - want.int()).abs().max()),
            "sha": sha(got),
        }
        if ops.order == "vh":
            split = make(plan, precision="fast", device=dev)
            cell["split_route_ms"] = _time_ms(lambda: split(x), 20, flush)
            cell["split_route_kernel"] = split.ops.launch_key
        times[f"{ops.launch_key} {name}"] = cell
    for name, route, sw, sh, nw, nh in KT_GAMMA_CELLS:
        plan = build_resize_plan(sw, sh, nw, nh, 3, np.uint8, np.uint8, use_srgb_gamma=True)
        os.environ[GAMMA_ROUTE_ENV] = route
        try:
            ops = make_avir_executor(plan, device=dev).ops
        finally:
            del os.environ[GAMMA_ROUTE_ENV]
        src = gen.integers(0, 256, (sh, sw * 3), dtype=np.uint8)
        x = torch.from_numpy(src).to(dev)
        if route == "prologue":
            k5_args = (x, ops.rows_pad, ops.lanes_pad, 3, -1, plan.in_gamma_mult)
            hi, lo = gp.apply_gamma_prologue(*k5_args)
            phi, plo = gp.apply_gamma_prologue_reference(*k5_args)
            torch.cuda.synchronize()
            times[f"gamma_prologue {name}"] = {
                "ms": _time_ms(lambda: gp.apply_gamma_prologue(*k5_args), 20, flush),
                "max_abs_err_vs_plain": max(int((hi.int() - phi.int()).abs().max()),
                                            int((lo.int() - plo.int()).abs().max())),
                "bound_ms": _k5_bound(x.numel(), *hi.shape)[0],
                "path": gp.load_path(x) if hasattr(gp, "load_path") else "byte",
                "sha": sha(torch.cat([hi.flatten(), lo.flatten()])),
            }
            args = (ops, hi, lo)
        else:
            args = (ops, x)
        if isinstance(ops, fk.FusedInt8Operands):
            kernel, plain = fk.apply_fused_int8, fk.apply_fused_int8_reference
        else:
            kernel, plain = fr.apply_fused_ring, fr.apply_fused_ring_reference
        got = kernel(*args)
        want = plain(*args)
        cell = {
            "ms": _time_ms(lambda: kernel(*args), 20, flush),
            "max_abs_err_vs_plain": int((got.int() - want.int()).abs().max()),
            "sha": sha(got),
        }
        if kernel is fk.apply_fused_int8 and route != "prologue":
            # The in-kernel gamma: its bound, the MACs issued against the
            # band's, the stagings per input element and every slice
            # height (a version whose operands carry no tiling, as the
            # dp4a kernels', prints none of these counts).
            bound_ms, bound_by, _, nops = _bound(plan, 3, ops.order, gamma=True)
            cell.update(bound_ms=bound_ms, bound_by=bound_by, band_macs=nops // 2)
            if getattr(ops, "slice_range", None) is not None:
                cell.update(_int8_counts(ops))
            cell["slice_heights"] = _height_sweep(ops, x, got, flush)
        times[f"{ops.launch_key} {name}"] = cell
    for name, sw, sh, nw, nh, kw in KT_K2_CELLS:
        plan = build_resize_plan(sw, sh, nw, nh, 3, np.uint8, np.uint8, **kw)
        ops = make_avir_executor(plan, errdiff=True, device=dev).ops
        src = gen.integers(0, 256, (sh, sw * 3), dtype=np.uint8)
        x = torch.from_numpy(src).to(dev)
        if plan.use_srgb_gamma:
            x = srgb_to_linear_2d(x.to(torch.int32).float() * f32(plan.in_gamma_mult),
                                  3, plan.alpha_index)
        k2_in = lk.apply_lanes(ops.lanes, x) if ops.order == "hv" else x
        got = bk.apply_banded(ops.rows, k2_in)
        want = bk.apply_banded_reference(ops.rows, k2_in)
        torch.cuda.synchronize()
        times[f"{ops.rows.launch_key} {name}"] = {
            "ms": _time_ms(lambda: bk.apply_banded(ops.rows, k2_in), 20, flush),
            "max_abs_err_vs_plain": float((got - want).abs().max()),
            "tol": float(want.abs().max()) * 1e-5,
            "sha": sha(got), "input_sha": sha(k2_in),
        }
        # K2 exact (no resize routes to it) on K3's output and, at the
        # first cell, on the u8 image (split2 beside it) and the image as
        # u16 (x 257).
        runs = [("exact f32", "exact", k2_in)]
        if name == KT_K2_CELLS[0][0]:
            image = torch.from_numpy(src).to(dev)
            u16 = torch.from_numpy(src.astype(np.uint16) * 257).to(dev)
            runs = [("split2 u8", "split2", image), ("exact u8", "exact", image),
                    ("exact u16", "exact", u16), *runs]
        for label, mode, inp in runs:
            o2 = bk.prepare_banded(ops.rows.bop, mode, dev)
            got = bk.apply_banded(o2, inp)
            want = bk.apply_banded_reference(o2, inp)
            torch.cuda.synchronize()
            bound = _k2_bound(plan.v.op, inp, mode)
            times[f"banded_{label} {name}"] = {
                "ms": _time_ms(lambda: bk.apply_banded(o2, inp), 20, flush),
                "max_abs_err_vs_plain": float((got - want).abs().max()),
                "tol": float(want.abs().max()) * 1e-5,
                "bound_ms": bound[0], "bound_by": bound[1], "slice_rows": o2.rows,
                "sha": sha(got),
            }
    for name, entry, sw, sh, nw, nh, out_dt, kw in KT_K3_CELLS:
        if entry == "lancir":
            plan = build_lancir_plan(sw, sh, nw, nh, 3, np.uint8, out_dt)
            ops, hop = make_lancir_executor(plan, device=dev).ops, plan.h
        else:
            plan = build_resize_plan(sw, sh, nw, nh, 3, np.uint8, out_dt, **kw)
            ops, hop = make_avir_executor(plan, errdiff=True, device=dev).ops, plan.h.op
        src = gen.integers(0, 256, (sh, sw * 3), dtype=np.uint8)
        x = torch.from_numpy(src).to(dev)
        if kw.get("use_srgb_gamma"):
            x = srgb_to_linear_2d(x.to(torch.int32).float() * f32(plan.in_gamma_mult),
                                  3, plan.alpha_index)
        got = lk.apply_lanes(ops.lanes, x)
        want = lk.apply_lanes_reference(ops.lanes, x)
        torch.cuda.synchronize()
        products = 3 if ops.lanes.mode == "split3" else 2
        times[f"{ops.lanes.launch_key} {name}"] = {
            "ms": _time_ms(lambda: lk.apply_lanes(ops.lanes, x), 20, flush),
            "max_abs_err_vs_plain": float((got - want).abs().max()),
            "tol": float(want.abs().max()) * 1e-5,
            "bound_ms": _pass_bound(hop, x.numel(), got.numel(), x.element_size(),
                                    products)[0],
            "input": f"{x.dtype} {list(x.shape)}", "order": ops.order,
            "sha": sha(got), "input_sha": sha(x),
        }
    for name, sw, sh, nw, nh, c, in_dt, out_dt, mv, mh, kw, _ in KT_PLANAR_CELLS:
        plan, g, alpha, out_t, out_max, x, k1 = _planar_setup(
            sw, sh, nw, nh, c, in_dt, out_dt, mv, mh, kw, gen, dev)
        vop, pop, k7, k8 = _planar_ops(plan, c, mv, mh, out_t, out_max, 0, g, alpha, dev)
        xp = pk.deinterleave(x, sh, sw, c, pk.plane_stride(vop), max(sw, pop.lanes_pad))
        k1_got = fs.apply_fused_split(k1, x)
        torch.cuda.synchronize()
        k1_cell = {"k1_split_ms": _time_ms(lambda: fs.apply_fused_split(k1, x), 20, flush),
                   "k1_split_variant": k1.launch_key, "k1_split_sha": sha(k1_got)}
        for ops, inp, kernel, plain in ((k7, xp, pk.apply_planar, pk.apply_planar_reference),
                                        (k8, x, p2.apply_planar2, p2.apply_planar2_reference)):
            got = kernel(ops, inp)
            want = plain(ops, inp)
            torch.cuda.synchronize()
            times[f"{ops.launch_key} {name}"] = {
                "ms": _time_ms(lambda: kernel(ops, inp), 20, flush),
                "max_abs_err_vs_plain": float((got.double() - want.double()).abs().max()),
                "tol": _split_int_tol(float(want.double().abs().max()), 1.0, g),
                "bound_ms": _planar_bound(plan, c, in_dt, out_dt, mv, mh, g)[0],
                "sha": sha(got), **k1_cell,
            }
    for cell in KT_SPLIT_HV_CELLS:
        plan, hv, vh, x, in_b, out_b = _split_hv_setup(cell, gen, dev)
        got = fs.apply_fused_split(hv, x)
        want = fs.apply_fused_split_reference(hv, x)
        vh_got = fs.apply_fused_split(vh, x)
        torch.cuda.synchronize()
        times[f"{hv.launch_key} {cell[0]}"] = {
            "ms": _time_ms(lambda: fs.apply_fused_split(hv, x), 20, flush),
            "max_abs_err_vs_plain": float((got.double() - want.double()).abs().max()),
            "tol": _split_gate(hv, want, float(x.double().abs().max())),
            "bound_ms": _split_bound(plan, cell[5], hv, in_b, out_b)[0],
            "slice_rows": hv.rows, **_split_counts(hv), "sha": sha(got),
            "vh_ms": _time_ms(lambda: fs.apply_fused_split(vh, x), 20, flush),
            "vh_variant": vh.launch_key, "vh_sha": sha(vh_got),
        }
    ptxas = {"fused_int8": _ptxas("fused_int8", "fused_int8"),
             "planar": _ptxas("planar", "planar"),
             "fused_split": _ptxas("fused_split", "fused_split"),
             "banded": _ptxas("banded", "banded")}
    print(json.dumps({"kernel_times": times, "ptxas": ptxas, "root": root, "card": _card()}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--kernel-times":
        return kernel_times(sys.argv[2])

    import avir_tpu_torch
    from avir_tpu_torch.models.runtime import make_avir_executor
    from avir_tpu_torch.ops.banded import block_banded
    from avir_tpu_torch.ops.cuda import banded_kernel as bk
    from avir_tpu_torch.ops.cuda import build
    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.ops.cuda import fused_ring as fr
    from avir_tpu_torch.ops.cuda import fused_split as fs
    from avir_tpu_torch.ops.cuda import gamma_prologue as gp
    from avir_tpu_torch.ops.cuda import lanes_kernel as lk
    from avir_tpu_torch.ops.cuda import planar as pk
    from avir_tpu_torch.ops.cuda import planar2 as p2
    from avir_tpu_torch.ops.cuda import wavefront as wf
    from avir_tpu_torch.ops.lanes import lane_block_banded
    from avir_tpu_torch.plan.plan import build_resize_plan

    smi = _card()
    print(smi)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}"
    )

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    report = build.build()
    BUILD_LOGS.update({name: info["log"] for name, info in report.items()})
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "built": sorted(report)}))
    for name, info in report.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"ptxas {name}: {line.strip()}", file=sys.stderr)

    dev = torch.device("cuda")
    gen = np.random.default_rng(SEED)
    # Full float32 products (no TF32) for the plain versions and the
    # exact route; the port checks this at each call.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    mods = (fk, fs, wf, bk, lk, gp, fr, pk, p2)

    # ---- 2. kernel vs plain on small cases -----------------------------
    for sw, sh, nw, nh, c, tile, order in KERNEL_CASES:
        plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
        ops = fk.prepare_fused_int8(
            block_banded(plan.v.op),
            lane_block_banded(plan.h.op, c, tile=tile),
            order, dev,
        )
        x = torch.from_numpy(
            gen.integers(0, 256, (sh, sw * c), dtype=np.uint8)
        ).to(dev)
        want = fk.apply_fused_int8_reference(ops, x)
        torch.cuda.synchronize()
        # The slice height slice_rows picked, then every other one.
        for rows in (ops.rows, *(r for r in INT8_ROWS[order] if r != ops.rows)):
            try:
                rops = fk.at_rows(ops, rows)
            except ValueError:  # an hv range above the intermediate's rows
                continue
            got = fk.apply_fused_int8(rops, x)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            case = f"{sw}x{sh}->{nw}x{nh} C={c} tile={tile} {order} rows={rows}"
            print(json.dumps({"case": case, "max_abs_err": err}))
            if err != 0:
                _fail(f"kernel != plain on {case}")

    for case_t in SPLIT_CASES:
        sw, sh, nw, nh, c, tile, order, mv, mh, tin, tout, tb = case_t
        ib = np.dtype(NP_TYPES[tin]).itemsize
        out_max = 255.0 if tout == "u8" else 65535.0
        plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout])
        ops = fs.prepare_fused_split(
            block_banded(plan.v.op, in_bytes=ib),
            lane_block_banded(plan.h.op, c, tile=tile, in_bytes=ib),
            order, mv, mh, dev, out_dtype=TORCH_TYPES[tout],
            out_max=out_max, trunc_bits=tb,
        )
        if tin == "f32":
            xn = gen.random((sh, sw * c), dtype=np.float32)
        else:
            xn = gen.integers(0, int(np.iinfo(NP_TYPES[tin]).max) + 1,
                              (sh, sw * c), dtype=NP_TYPES[tin])
        x = torch.from_numpy(xn).to(dev)
        got = fs.apply_fused_split(ops, x)
        torch.cuda.synchronize()
        want = fs.apply_fused_split_reference(ops, x)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        tol = _split_gate(ops, want, float(np.abs(xn).max()))
        case = f"{sw}x{sh}->{nw}x{nh} C={c} tile={tile} {order} {mv}/{mh} {tin}->{tout} tb={tb}"
        print(json.dumps({"case": case, "max_abs_err": err, "tol": tol}))
        if not err <= tol:
            _fail(f"split kernel != plain on {case}")

    for h, w, c, tb, om, rows in WAVEFRONT_CASES:
        img = torch.from_numpy(
            (gen.random((h, w, c)) * om).astype(np.float32)
        ).to(dev)
        # Both sum orders: the wavefront's and the sequential scan's
        # (dither="errdiff-device").
        for scan in (False, True):
            got = wf.errdiff_wavefront(img, tb, om, block_rows=rows, scan_order=scan)
            torch.cuda.synchronize()
            want = wf.errdiff_wavefront_reference(
                img, tb, om, block_rows=rows, scan_order=scan
            )
            err = float((got - want).abs().max())
            case = f"wavefront {h}x{w}x{c} tb={tb} max={om} rows={rows} scan={scan}"
            print(json.dumps({"case": case, "max_abs_err": err}))
            # Bit-equal expected everywhere (same float32 operations in the
            # same order); the gate is the reference's own engine tolerance.
            if not err <= (0.0 if tb == 0 else om / (int(om) >> tb)):
                _fail(f"wavefront kernel != plain on {case}")

    _epi_cases(gen, dev)
    _unfused_cases(gen, dev)
    _ring_cases(gen, dev)
    _planar_cases(gen, dev)
    gen2 = np.random.default_rng(SEED + 1)
    _split_epi_cases(SPLIT_VH_UP_CASES, gen2, dev)
    _split_epi_cases(SPLIT_VH_EDGE_CASES, np.random.default_rng(SEED + 2), dev)
    _split_epi_cases(SPLIT_HV_EDGE_CASES, np.random.default_rng(SEED + 4), dev)
    _split_epi_cases(SPLIT_FAST_CASES, np.random.default_rng(SEED + 5), dev)
    for h, w, c, tb, om, rows in K4_GROUP_CASES:
        img = torch.from_numpy((gen2.random((h, w, c)) * om).astype(np.float32)).to(dev)
        got = wf.errdiff_wavefront(img, tb, om, block_rows=rows)
        torch.cuda.synchronize()
        ok = torch.equal(got, wf.errdiff_wavefront_reference(img, tb, om))
        case = f"wavefront {h}x{w}x{c} tb={tb} max={om} group rows={rows}"
        print(json.dumps({"case": case, "bit_equal": bool(ok)}))
        if not ok:
            _fail(f"wavefront kernel != plain on {case}")

    # ---- 3./4. main path, checks and timing ----------------------------
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    entries = []
    seen = set()

    def add(new: list[dict]) -> None:
        # One entry per kernel: its first main-path shape.
        for e in new:
            if e["name"] not in seen:
                seen.add(e["name"])
                entries.append(e)

    for name, sw, sh, nw, nh, c in MAIN_PATH:
        src = gen.integers(0, 256, (sh, sw, c), dtype=np.uint8)
        order = "vh" if nw * nh <= sw * sh else "hv"
        kname = f"fused_int8_{order}"

        resizer = avir_tpu_torch.ImageResizer()
        _zero(mods)
        t0 = time.perf_counter()
        out = resizer.resize(src, nw, nh)
        first_s = time.perf_counter() - t0
        counts = _counts(mods)
        print(json.dumps({"main_path": name, "launches": counts}))
        if counts[kname] != 1 or sum(counts.values()) != 1:
            _fail(f"{name}: {kname} was not launched once on the main path: {counts}")
        # Host wall time of a resize whose executor is cached: numpy in,
        # host->device copy, one kernel, device->host copy, numpy out.
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            resizer.resize(src, nw, nh)
            walls.append(1e3 * (time.perf_counter() - t0))

        plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
        fn = make_avir_executor(plan)
        ops = fn.ops
        x = torch.from_numpy(src.reshape(sh, sw * c)).to(dev)
        got = fk.apply_fused_int8(ops, x)
        want = fk.apply_fused_int8_reference(ops, x)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        same_as_resize = bool(
            np.array_equal(got.cpu().numpy().reshape(nh, nw, c), out)
        )
        oracle = _oracle(plan, src)
        lsb = int(np.abs(out.astype(np.int16) - oracle.astype(np.int16)).max())
        psnr = _psnr(out, oracle)
        ok = out.shape == (nh, nw, c) and err == 0 and same_as_resize \
            and lsb <= 1 and psnr >= 60.0

        ms = _time_ms(lambda: fk.apply_fused_int8(ops, x), 30, flush)
        plain_ms = _time_ms(
            lambda: fk.apply_fused_int8_reference(ops, x), 3, flush
        )
        h2d_ms = _time_ms(
            lambda: torch.from_numpy(src.reshape(sh, -1)).to(dev), 5, flush
        )
        d2h_ms = _time_ms(lambda: got.cpu(), 5, flush)
        bound_ms, bound_by, nbytes, nops = _bound(plan, c, order)
        yard = _yardsticks(
            make_avir_executor, plan, x, got,
            (EXACT_ROUTE, SPLIT_ROUTE) if order == "vh" else (EXACT_ROUTE,), dev, flush,
        )
        heights = _height_sweep(ops, x, got, flush)
        ok = ok and all(h["bit_equal"] for h in heights.values())
        if name == "8k_to_1080p":
            mesh_in = (src, oracle, ms)  # the mesh phase's 8K image
        print(json.dumps({
            "shape": name, "kernel": kname, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "int8_ops": nops, "band_macs": nops // 2, **_int8_counts(ops),
            "max_abs_err_vs_plain": err,
            "max_lsb_vs_f64_oracle": lsb, "psnr_vs_f64_oracle_db": psnr,
            **yard, "slice_heights": heights,
            "resize_first_call_s": first_s,
            "resize_cached_wall_ms": sorted(walls)[len(walls) // 2],
            "h2d_copy_ms": h2d_ms, "d2h_copy_ms": d2h_ms,
            "card": smi,
        }))
        if not ok:
            _fail(
                f"{name}: shape {out.shape}, kernel-vs-plain {err}, same as "
                f"resize {same_as_resize}, oracle {lsb} LSB / {psnr} dB"
            )
        add([{
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": KERNELS[kname], "launches": counts[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        }])

    for name, sw, sh, nw, nh, c, in_dt, bits, dith in NEW_SHAPES:
        g = np.random.default_rng(SEED) if name == "1080p_to_4k_errdiff" else gen
        add(_new_shape(
            name, sw, sh, nw, nh, c, in_dt, bits, dith, g, dev, flush, smi,
            mods,
        ))
    for shape in EPI_SHAPES:
        add(_epi_shape(*shape, gen, dev, flush, smi, mods))
    for shape in UNFUSED_SHAPES:
        add(_unfused_shape(*shape, gen, dev, flush, smi, mods))
    for shape in PROLOGUE_SHAPES:
        add(_prologue_shape(*shape, gen, dev, flush, smi, mods))
    for shapes, drive in ((RING_SHAPES, _ring_shape), (PLANAR_SHAPES, _planar_shape)):
        for shape in shapes:
            add(drive(*shape, gen, dev, flush, smi, mods))
    for shape in API_BATCH_SHAPES:
        _batch_phase(*shape, gen, dev, flush, smi, mods)
    _device_fn_phase(gen, dev, flush, smi, mods)
    _errdiff_device_phase(gen, dev, flush, smi, mods)
    _cli_phase(gen, smi, mods)
    overhead, pts_1d = _mesh_phase(gen, dev, smi, *mesh_in)
    _mesh2d_phase(gen, dev, smi, *mesh_in, overhead, pts_1d)
    missing = sorted(set(KERNELS) - seen)
    if missing:
        _fail(f"kernels without an entry: {missing}")

    print(json.dumps({"kernels": entries}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
