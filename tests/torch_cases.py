"""Case tables and inputs shared by the port's CPU parity tests (which also
import the JAX package) and its card-only tests (test_torch_cuda.py, which
import no JAX, so that they run where only PyTorch and the CUDA toolkit
are installed)."""

import numpy as np

# K1 int8: (src_w, src_h, new_w, new_h, c, lane tile or None); downsizes
# run "vh", upsizes "hv"; the lane form is chunked or not as noted.
FUSED_CASES = {
    "down_c1": (150, 90, 61, 37, 1, None),      # unchunked (TC = 128)
    "down_c3": (200, 150, 80, 60, 3, None),     # chunked
    "down_c4": (181, 77, 60, 33, 4, None),      # chunked
    "up_c1": (45, 31, 97, 70, 1, None),         # unchunked
    "up_c1_wide": (2000, 12, 4100, 25, 1, None),  # chunked (wide tile)
    "up_c3": (300, 20, 1400, 41, 3, None),      # chunked (wide tile)
    "up_c3_flat": (40, 30, 64, 48, 3, None),    # unchunked
    "up_c4": (500, 20, 1200, 41, 4, None),      # chunked (wide tile)
    "up_c4_tc": (29, 21, 71, 45, 4, 48),        # TC = 192, unchunked
    "down_c3_tc": (120, 80, 70, 50, 3, 50),     # TC = 150, unchunked
    # Edges of the tensor-core kernels' tiling (test_torch_fused.py checks
    # each case has them): rows_out not a multiple of any slice height,
    # nonzero lane ranges ending inside a 32-deep MMA step, C = 2, a
    # downsize by more than 4, odd lanes_in (rows not 16-byte aligned), an
    # hv upsize at 128-row slices with a ragged last slice, and an hv whose
    # slice range exceeds the intermediate's 256 rows (windows).
    "edge_rows_c3": (300, 250, 170, 150, 3, None),
    "edge_down_c2": (97, 83, 61, 45, 2, None),
    "edge_down5_c3": (1031, 517, 200, 97, 3, None),
    "edge_up_odd_c3": (45, 31, 97, 70, 3, None),
    "edge_up_c2": (53, 37, 90, 71, 2, None),
    "edge_up128_c3": (150, 100, 400, 300, 3, None),
    "edge_hv_windows_c1": (20, 1200, 500, 50, 1, None),
    # More than 4 channels: the lane operators carry C in their lanes.
    "c5_down": (90, 60, 40, 27, 5, None),
    "c5_up": (33, 21, 70, 45, 5, None),
    "c8_down": (100, 70, 45, 31, 8, None),
    "c8_up": (30, 20, 61, 47, 8, None),
}

# K1 split-bf16: (src_w, src_h, new_w, new_h, c, lane tile or None,
# order, mode_v, mode_h, in type, out type, trunc_bits).  Downsizes run
# "vh", upsizes "hv" (as the port routes them), plus each order on the
# other direction.
SPLIT_CASES = {
    "down_c3_u8_f32": (200, 150, 80, 60, 3, None, "vh", "split2", "split3", "u8", "f32", 0),
    "down_c1_u8_u8": (150, 90, 61, 37, 1, None, "vh", "split2", "split3", "u8", "u8", 0),
    "down_c4_u16_u16_tb4": (181, 77, 60, 33, 4, None, "vh", "split3", "split3", "u16", "u16", 4),
    "down_c3_f32_u8_tb2": (120, 80, 70, 50, 3, 50, "vh", "split3", "split3", "f32", "u8", 2),
    "down_c3_u8_u8_fast": (200, 150, 80, 60, 3, None, "vh", "split2", "split2", "u8", "u8", 0),
    "up_c1_u16_u16": (45, 31, 97, 70, 1, None, "hv", "split3", "split3", "u16", "u16", 0),
    "up_c3_u8_f32": (300, 20, 1400, 41, 3, None, "hv", "split3", "split2", "u8", "f32", 0),
    "up_c4_f32_f32": (29, 21, 71, 45, 4, 48, "hv", "split3", "split3", "f32", "f32", 0),
    "up_c3_u8_u16_tb2": (40, 30, 64, 48, 3, None, "hv", "split2", "split2", "u8", "u16", 2),
    "up_c4_u16_u8": (500, 20, 1200, 41, 4, None, "hv", "split3", "split3", "u16", "u8", 0),
    "other_vh_c3_u16_f32": (96, 80, 70, 101, 3, None, "vh", "split3", "split3", "u16", "f32", 0),
    "other_hv_c1_u8_u8_tb4": (96, 80, 70, 101, 1, None, "hv", "split3", "split2", "u8", "u8", 4),
    # 2- and 4-byte upsizes on both axes run "vh" (choose_fused).
    "up_vh_c3_u16_u16": (45, 31, 97, 70, 3, None, "vh", "split3", "split3", "u16", "u16", 0),
    "up_vh_c1_f32_f32": (40, 30, 64, 48, 1, None, "vh", "split3", "split3", "f32", "f32", 0),
    "up_vh_c2_f32_u16": (53, 37, 90, 71, 2, None, "vh", "split3", "split3", "f32", "u16", 0),
    "up_vh_c4_u16_u16_tc": (29, 21, 71, 45, 4, 48, "vh", "split3", "split3", "u16", "u16", 0),
    # Edges of the vh kernel's tiling (64-row slices, lane segments in
    # steps of 32, 16-deep MMA steps; test_torch_split.py checks each case
    # has them): rows_out not a multiple of 64, nonzero V-tap ranges and
    # lane windows that end inside an MMA step, C = 2, a u16 output with
    # trunc_bits=4, a downsize by more than 4 (1031x517 -> 200x97), and
    # rows of lanes_in not a multiple of 4 (the kernel's scalar loads).
    "vh_edge_rows_u8_f32": (300, 250, 170, 150, 3, None, "vh", "split2", "split3", "u8", "f32", 0),
    "vh_edge_c2_u16_u16": (97, 83, 61, 45, 2, None, "vh", "split3", "split3", "u16", "u16", 0),
    "vh_edge_tb4_u16_u16": (150, 120, 90, 70, 3, None, "vh", "split3", "split3", "u16", "u16", 4),
    "vh_edge_down5_u8_u8": (1031, 517, 200, 97, 3, None, "vh", "split2", "split3", "u8", "u8", 0),
    "vh_edge_up_c2_f32_f32": (45, 31, 97, 70, 2, None, "vh", "split3", "split3", "f32", "f32", 0),
    # More than 4 channels.
    "c5_down_u16_u16": (90, 60, 40, 27, 5, None, "vh", "split3", "split3", "u16", "u16", 0),
    "c5_up_vh_f32_u8_tb2": (33, 21, 70, 45, 5, None, "vh", "split3", "split3", "f32", "u8", 2),
    "c8_up_u8_f32": (30, 20, 61, 47, 8, None, "hv", "split2", "split3", "u8", "f32", 0),
    "c8_down_u8_u8": (100, 70, 45, 31, 8, None, "vh", "split2", "split3", "u8", "u8", 0),
    # precision="fast" to float32 output: a split2 second pass, whose
    # intermediate hi parts two summation orders can round one bf16 ulp
    # apart (split2_tol), in both orders.
    "down_c3_u8_f32_fast": (200, 150, 80, 60, 3, None, "vh", "split2", "split2", "u8", "f32", 0),
    "up_c3_u8_f32_fast": (80, 60, 200, 150, 3, None, "hv", "split2", "split2", "u8", "f32", 0),
}

# K1 int8 epilogue variants: (src_w, src_h, new_w, new_h, c, lane tile
# or None, order, round_mode, scale, gamma, alpha_index).  "even" is
# LANCIR's round-half-even (its int8 route has scale 1); gamma linearizes
# the u8 input to 13-bit linear light.
INT8_EPI_CASES = {
    "even_down_c1": (150, 90, 61, 37, 1, None, "vh", "even", 1.0, False, -1),
    "even_down_c3": (200, 150, 80, 60, 3, None, "vh", "even", 1.0, False, -1),
    "even_down_c4_scale": (181, 77, 60, 33, 4, None, "vh", "even", 0.75, False, -1),
    "even_down_c3_tc": (120, 80, 70, 50, 3, 50, "vh", "even", 1.0, False, -1),
    "even_up_c1": (45, 31, 97, 70, 1, None, "hv", "even", 1.0, False, -1),
    "even_up_c3": (300, 20, 1400, 41, 3, None, "hv", "even", 1.0, False, -1),
    "even_up_c4_tc": (29, 21, 71, 45, 4, 48, "hv", "even", 1.0, False, -1),
    "gamma_down_c3": (200, 150, 80, 60, 3, None, "vh", "biased", 1.0, True, -1),
    "gamma_down_c4a": (181, 77, 60, 33, 4, None, "vh", "biased", 1.0, True, 3),
    "gamma_down_c4a0_tc": (120, 80, 70, 50, 4, 50, "vh", "biased", 1.0, True, 0),
    "gamma_up_c3": (300, 20, 1400, 41, 3, None, "hv", "biased", 1.0, True, -1),
    "gamma_up_c4a": (500, 20, 1200, 41, 4, None, "hv", "biased", 1.0, True, 3),
    "gamma_up_c4a_tc": (29, 21, 71, 45, 4, 48, "hv", "biased", 1.0, True, 3),
    # Edges of the in-kernel gamma's tiling on the s8 tensor cores
    # (test_torch_fused.py checks each case has them): rows_out off 32,
    # 64 and 128 in both orders (hv with a ragged last 128-row slice),
    # lanes_in odd (C = 3: the narrow image loads; off 16, the hv tile's
    # word loads), C = 4 with the alpha lane first in hv, and an hv whose
    # slice range runs taller than the intermediate (windows at R = 32).
    "gamma_edge_rows_down_c3": (300, 250, 170, 150, 3, None, "vh", "biased", 1.0, True, -1),
    "gamma_edge_rows_up_c3": (150, 100, 400, 300, 3, None, "hv", "biased", 1.0, True, -1),
    "gamma_odd_down_c3": (97, 83, 61, 45, 3, None, "vh", "biased", 1.0, True, -1),
    "gamma_odd_up_c3": (45, 31, 97, 70, 3, None, "hv", "biased", 1.0, True, -1),
    "gamma_up_c4a0": (53, 37, 90, 71, 4, None, "hv", "biased", 1.0, True, 0),
    "gamma_hv_windows_c1": (20, 1200, 500, 50, 1, None, "hv", "biased", 1.0, True, -1),
    # LANCIR's scale on the tensor-core kernels' edge cases, both orders.
    "even_scale_edge_down": (300, 250, 170, 150, 3, None, "vh", "even", 0.75, False, -1),
    "even_scale_edge_up": (150, 100, 400, 300, 3, None, "hv", "even", 0.75, False, -1),
}

# K1 split-bf16 epilogue variants: SPLIT_CASES' fields plus round_mode,
# scale, gamma, alpha_index.  The scales are LANCIR's out_mul (u16 -> u8,
# u8 -> u16, and float output, which is written unscaled).
SPLIT_EPI_CASES = {
    "even_down_u16_u8": (181, 77, 60, 33, 3, None, "vh", "split3", "split3", "u16", "u8", 0, "even", 255.0 / 65535.0, False, -1),
    "even_up_u8_u16": (40, 30, 64, 48, 4, None, "hv", "split3", "split2", "u8", "u16", 0, "even", 65535.0 / 255.0, False, -1),
    "even_down_f32_f32": (120, 80, 70, 50, 3, 50, "vh", "split3", "split3", "f32", "f32", 0, "even", 0.5, False, -1),
    "even_up_u8_u8_fast": (300, 20, 1400, 41, 3, None, "hv", "split2", "split2", "u8", "u8", 0, "even", 1.0, False, -1),
    "gamma_down_u8_u8": (200, 150, 80, 60, 3, None, "vh", "split3", "split3", "u8", "u8", 0, "biased", 1.0, True, -1),
    "gamma_down_u16_u16_c4a": (181, 77, 60, 33, 4, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 3),
    "gamma_down_u8_f32": (150, 90, 61, 37, 1, None, "vh", "split3", "split3", "u8", "f32", 0, "biased", 1.0, True, -1),
    "gamma_up_u16_u16_c4a": (45, 31, 97, 70, 4, None, "hv", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 3),
    "gamma_up_u8_f32_c4a0": (29, 21, 71, 45, 4, 48, "hv", "split3", "split3", "u8", "f32", 0, "biased", 1.0, True, 0),
    "gamma_up_f32_u8_tb2": (300, 20, 1400, 41, 3, None, "hv", "split3", "split3", "f32", "u8", 2, "biased", 1.0, True, -1),
    # 2- and 4-byte gamma upsizes on both axes run "vh" (choose_fused).
    "gamma_up_vh_u16_u16_c4a": (45, 31, 97, 70, 4, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 3),
    "gamma_up_vh_f32_f32_c3": (40, 30, 64, 48, 3, None, "vh", "split3", "split3", "f32", "f32", 0, "biased", 1.0, True, -1),
    "gamma_up_vh_u16_u16_c1": (53, 37, 90, 71, 1, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, -1),
    # u16 gamma with the alpha lane first (alpha_index=0) in the vh kernel.
    "gamma_vh_edge_u16_u16_c4a0": (181, 77, 60, 33, 4, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 0),
    "gamma_up_vh_edge_u16_u16_c4a0": (53, 37, 90, 71, 4, None, "vh", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 0),
}

# Edges of the hv kernel's tiling (64-row slices, 32-row groups of the
# slice's V-tap range, 32 window lanes a first-pass step, 16-deep MMA
# steps; test_torch_split.py checks each case has them): rows_out not a
# multiple of 64, nonzero V-tap ranges and lane windows that end inside an
# MMA step, C = 2, 5 and 8, lanes_in not a multiple of 4 (the kernel's
# scalar loads), a slice's V-tap range many groups tall, gamma with the
# alpha lane first and last, and u16 output with trunc_bits=4.
# SPLIT_EPI_CASES' fields.
SPLIT_HV_EDGE_CASES = {
    "hv_edge_rows_u8_f32": (150, 100, 400, 300, 3, None, "hv", "split3", "split2", "u8", "f32", 0, "biased", 1.0, False, -1),
    "hv_edge_c2_u16_u16": (53, 37, 90, 71, 2, None, "hv", "split3", "split3", "u16", "u16", 0, "biased", 1.0, False, -1),
    "hv_edge_c5_u8_u8": (33, 21, 70, 45, 5, None, "hv", "split3", "split2", "u8", "u8", 0, "biased", 1.0, False, -1),
    "hv_edge_c8_f32_f32": (30, 20, 61, 47, 8, None, "hv", "split3", "split3", "f32", "f32", 0, "biased", 1.0, False, -1),
    "hv_edge_tb4_u16_u16": (40, 30, 97, 70, 3, None, "hv", "split3", "split3", "u16", "u16", 4, "biased", 1.0, False, -1),
    "hv_edge_tall_u8_u8": (20, 1200, 500, 50, 1, None, "hv", "split3", "split2", "u8", "u8", 0, "biased", 1.0, False, -1),
    "hv_edge_gamma_a0_u16_u16": (45, 31, 97, 70, 4, None, "hv", "split3", "split3", "u16", "u16", 0, "biased", 1.0, True, 0),
    "hv_edge_gamma_a3_u8_u8": (53, 37, 90, 71, 4, None, "hv", "split3", "split3", "u8", "u8", 0, "biased", 1.0, True, 3),
}

# K5 + K1 int8 limb-plane input: (src_w, src_h, new_w, new_h, c, lane tile
# or None, order, alpha_index); sRGB gamma, u8 in and out.  The first two
# are tests/test_pallas_kernel.py:808-811's.
GAMMA_PRE_CASES = {
    "down_c3": (200, 150, 80, 60, 3, None, "vh", -1),
    "up_c4a": (80, 60, 200, 150, 4, None, "hv", 3),
    "down_c1": (150, 90, 61, 37, 1, None, "vh", -1),
    "down_c4a0_tc": (120, 80, 70, 50, 4, 50, "vh", 0),
    "up_c3": (300, 20, 1400, 41, 3, None, "hv", -1),
    "up_c4_tc": (29, 21, 71, 45, 4, 48, "hv", -1),
    "up_c1": (45, 31, 97, 70, 1, None, "hv", -1),
    # K5's edges (test_torch_gamma_pre checks each): the byte path (lanes
    # off a multiple of 16) with C = 4 and the alpha lane last and first,
    # and more than one block of 16-lane groups on the vector path.  Every
    # case has planes wider and taller than the image.
    "byte_c4a3": (81, 64, 40, 30, 4, None, "vh", 3),
    "byte_c4a0_up": (43, 29, 90, 61, 4, None, "hv", 0),
    "wide_vec_c3": (448, 40, 200, 20, 3, None, "vh", -1),
}

# K6, the shift-ring int8 gamma route: (src_w, src_h, new_w, new_h, c,
# alpha_index, V tile or None, uniform blocking).  The first five are
# tests/test_pallas_kernel.py:854-862's (the first three on the default
# blocking, whose offsets are already uniform; the last two with pad_top).
RING_CASES = {
    "pre1_c3": (256, 768, 64, 192, 3, -1, 64, False),
    "pre1_c4a": (128, 768, 32, 192, 4, 3, 64, False),
    "pre2_c3": (384, 512, 96, 128, 3, -1, None, False),
    "uniform_c3": (512, 1024, 128, 256, 3, -1, 64, True),
    "uniform_2x_c4a": (256, 960, 128, 480, 4, 3, 64, True),
    "uniform_c1": (640, 1024, 160, 256, 1, -1, 64, True),
}

# K6's thread block clusters: ring cases on the executor's blocking
# (default V tile, uniform) whose largest chunk window spans 8, 12 and 16
# 128-lane segments (the most a cluster takes), with lanes_in off a multiple
# of 4 (narrow image loads) or of 128 (a segment partly past the image), V
# tap ranges of 96 and 160 rows (ending inside a 64-row step) and C = 4
# with the alpha bypass.  RING_CASES give windows of 4, 5 and 6.
RING_CLUSTER_CASES = {
    "win8_c3_narrow": (1030, 640, 170, 160, 3, -1, None, True),
    "win12_c3": (1024, 640, 128, 160, 3, -1, None, True),
    "win16_c1": (2048, 640, 128, 160, 1, -1, None, True),
    "win5_v96_c3": (384, 720, 128, 240, 3, -1, None, True),
    "win5_c3_partial": (300, 480, 100, 160, 3, -1, None, True),
    "win_c4a3": (768, 640, 128, 160, 4, 3, None, True),
    "win_c4a0": (400, 720, 100, 240, 4, 0, None, True),
}

# Edges of the vh kernel's ring of stages (fused_int8.cu: VhMma<IN>), each
# run in every input mode (no gamma, round-half-even with LANCIR's scale,
# the in-kernel gamma, K5's limb planes): (src_w, src_h, new_w, new_h, c,
# lane tile or None).  All but the last have 16-byte aligned rows (the
# cp.async path); test_torch_fused.py checks each case has its edge.
VH_RING_CASES = {
    "ring_under_one_step": (16, 12, 14, 11, 1, None),  # a 32-row slice range: 2 steps, under the stages
    "ring_kw_off64": (400, 200, 180, 70, 4, None),     # slice ranges of 160 rows, 19 steps a block
    "ring_seg32_seg96": (512, 150, 200, 66, 3, None),  # last segments of 32 and 96 lanes
    "ring_no_taps": (32, 70, 28, 66, 3, None),         # a slice and a chunk without nonzero taps
    "ring_odd_lanes": (333, 200, 150, 90, 3, None),    # lanes_in odd: rows not 16-byte aligned
}
# The same as INT8_EPI_CASES and GAMMA_PRE_VH_CASES entries.
VH_RING_EPI_CASES = {
    **{f"{n}_even_scale": (*case, "vh", "even", 0.75, False, -1) for n, case in VH_RING_CASES.items()},
    **{f"{n}_gamma": (*case, "vh", "biased", 1.0, True, 3 if case[4] == 4 else -1)
       for n, case in VH_RING_CASES.items()},
}
VH_RING_PRE_CASES = {n: (*case, -1) for n, case in VH_RING_CASES.items()}

# The hv kernel's pipeline forms (fused_kernel.hv_blocks) on an H100's 132
# SMs, each run in every input mode (no gamma, round-half-even with
# LANCIR's scale, the in-kernel gamma, K5's limb planes) at every slice
# height it takes: (src_w, src_h, new_w, new_h, c, alpha_index, the form
# at slice_rows' height, the heights, slice_rows' first).  Runs longer
# than one slice with a ragged last slice inside them (1080p -> 4K: 2160
# rows), C = 4 with the alpha lane last and first, a run in windows (one
# block an SM), chunks wider than one 128-lane piece (their taps restaged
# every step), and one tile a block where the tiles fit the card at once.
# test_torch_fused.py checks each case has its edge.
HV_RUN_CASES = {
    "runs_1080p_c3": (1920, 1080, 3840, 2160, 3, -1, "runs", (128, 64, 32)),
    "runs_c4a3": (960, 540, 1920, 1080, 4, 3, "runs", (128, 64, 32)),
    "runs_c4a0": (960, 540, 1920, 1080, 4, 0, "runs", (128,)),
    "runs_windows_c1": (300, 2400, 12000, 100, 1, -1, "runs", (32,)),
    "runs_pieces_c3": (640, 480, 1024, 768, 3, -1, "runs", (64, 32)),
    "one_tile_c3": (320, 240, 640, 480, 3, -1, "one_tile", (32, 64, 128)),
}
HV_RUN_MODES = ("u8", "even_scale", "gamma", "planes")

# K1 int8 vh from K5's limb planes on the tensor cores: (src_w, src_h,
# new_w, new_h, c, lane tile, alpha_index), downsizes at the edges of the
# tiling (FUSED_CASES' edge_* shapes: rows_out off 32, C = 2, a downsize
# by more than 4, nonzero lane ranges ending inside a 64-lane step) and
# C = 4 with the alpha bypass.
GAMMA_PRE_VH_CASES = {
    "edge_rows_c3": (300, 250, 170, 150, 3, None, -1),
    "edge_down_c2": (97, 83, 61, 45, 2, None, -1),
    "edge_down5_c3": (1031, 517, 200, 97, 3, None, -1),
    "c4a3": (181, 77, 60, 33, 4, None, 3),
    "c4a0_tc": (120, 80, 70, 50, 4, 50, 0),
    "c5": (90, 60, 40, 27, 5, None, -1),
}

# K1 int8 hv from K5's limb planes on the s8 tensor cores (fused_int8.cu:
# fused_int8_hv_mma<R, true>): (src_w, src_h, new_w, new_h, c, lane tile or
# None, alpha_index), each run at every slice height (32, 64, 128).  A
# slice range above the intermediate's 256 rows (windows at R = 32), C = 4
# with the alpha bypass first and last, lanes_in not a multiple of 4, C = 2
# and C = 5, an hv at 128-row slices with a ragged last slice.
GAMMA_PRE_HV_CASES = {
    "windows_c1": (20, 1200, 500, 50, 1, None, -1),
    "narrow_c3": (45, 31, 97, 70, 3, None, -1),
    "c4a3": (80, 60, 200, 150, 4, None, 3),
    "c4a0_tc": (29, 21, 71, 45, 4, 48, 0),
    "edge_up128_c3": (150, 100, 400, 300, 3, None, -1),
    "c2": (53, 37, 90, 71, 2, None, -1),
    "c5": (30, 20, 61, 47, 5, None, -1),
}

# K7 (planar input) and K8 (interleaved input): (src_w, src_h, new_w,
# new_h, c, in type, out type, mode_v, mode_h, trunc_bits, gamma,
# alpha_index).  The first three are tests/test_pallas_kernel.py:560-750's;
# then C = 1, float32 input, trunc_bits and the other channel counts.
PLANAR_CASES = {
    "down_c3_u8_f32": (200, 150, 80, 60, 3, "u8", "f32", "split2", "split3", 0, False, -1),
    "down_c3_u8_u8": (200, 150, 80, 60, 3, "u8", "u8", "split2", "split3", 0, False, -1),
    "up_c4_u16_gamma_a3": (96, 80, 144, 120, 4, "u16", "u16", "split3", "split3", 0, True, 3),
    "down_c1_f32_f32": (150, 90, 61, 37, 1, "f32", "f32", "split3", "split3", 0, False, -1),
    "down_c4_u8_gamma_a0_tb2": (120, 80, 70, 50, 4, "u8", "u8", "split3", "split2", 2, True, 0),
    "up_c3_u16_u8": (45, 31, 97, 70, 3, "u16", "u8", "split3", "split3", 0, False, -1),
    "up_c1_u8_u16_tb2": (40, 30, 64, 48, 1, "u8", "u16", "split2", "split2", 2, False, -1),
    "down_c4_f32_u16_gamma_a3": (181, 77, 60, 33, 4, "f32", "u16", "split3", "split3", 0, True, 3),
    "up_c3_u8_gamma_f32": (53, 37, 90, 71, 3, "u8", "f32", "split3", "split3", 0, True, -1),
    # Edges of the kernel's tensor-core tiling (64-row slices x 128-pixel
    # chunks, 32-deep steps): Tv of 32 and 40 (not a multiple of the slice
    # height); a last H block with fewer than 128 output pixels; h_range
    # segments that end 32 or 96 pixels into a 128-pixel segment; windows
    # that start 32 pixels in; K7 plane widths and K8 row widths off 16
    # bytes (the loads' gather path and K8's strided loads; PLANAR_PAD_W
    # widens K7's planes) and K8 rows on 16 bytes (its raw span tile, u8 C =
    # 3, u16 C = 3, f32 C = 1); f32 in; alpha planes that are not the last
    # (K7 and K8 then differ at C = 3: K8 masks gamma-in only at C = 4);
    # a split2 second pass with float32 output (split2_tol).
    "edge_tv32_c3_u8_u8": (80, 37, 300, 29, 3, "u8", "u8", "split2", "split3", 0, False, -1),
    "edge_segs_c1_u8_f32": (259, 37, 29, 29, 1, "u8", "f32", "split2", "split2", 0, False, -1),
    "edge_segs_c1_u8_f32_h3": (259, 37, 29, 29, 1, "u8", "f32", "split2", "split3", 0, False, -1),
    "edge_tv40_c1_f32_f32": (1000, 333, 90, 40, 1, "f32", "f32", "split3", "split3", 0, False, -1),
    "edge_alpha1_c3_u16_gamma": (200, 37, 150, 29, 3, "u16", "u16", "split3", "split3", 0, True, 1),
    "edge_c4_u8_gamma_a0": (131, 90, 97, 70, 4, "u8", "u8", "split2", "split3", 0, True, 0),
}

# Extra pixels of K7's plane width beyond max(src_w, lanes_pad) for some
# PLANAR_CASES: plane rows off 16 bytes.
PLANAR_PAD_W = {"edge_segs_c1_u8_f32": 3, "edge_segs_c1_u8_f32_h3": 3,
                "edge_alpha1_c3_u16_gamma": 2, "edge_c4_u8_gamma_a0": 1}


def unaligned_copy(x):
    """``x`` copied to a base one element past a 16-byte boundary: the
    same image on K8's strided loads (planar.raw_row_bytes gives 0)."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def plane_width(name, src_w, lanes_pad):
    """K7's plane width (``deinterleave``'s wp) for PLANAR_CASES[name]."""
    return max(src_w, lanes_pad) + PLANAR_PAD_W.get(name, 0)

# K2 (row pass) on the card: (src_w, src_h, new_w, new_h, c, in type,
# mode); the pass runs over the image's rows.
BANDED_CASES = {
    "up_c1_u8_split2": (53, 37, 90, 71, 1, "u8", "split2"),
    "up_c3_u16_split3": (53, 37, 90, 71, 3, "u16", "split3"),
    "down_c4_f32_split3": (150, 97, 61, 40, 4, "f32", "split3"),
    "down_c3_u8_exact": (150, 97, 61, 40, 3, "u8", "exact"),
    "up_c4_f32_exact": (40, 30, 64, 101, 4, "f32", "exact"),
    "down_c1_u16_split2": (150, 97, 61, 40, 1, "u16", "split2"),
    "down_c8_u8_split3": (150, 97, 61, 40, 8, "u8", "split3"),
    # The edges of the split modes' tensor-core tiling (64-row slices x 128
    # columns, 16 columns a thread by 16-byte loads where the row width
    # allows): every input type in both split modes, rows whose width in
    # bytes is off 16 (scalar loads) and on it, R not a multiple of 8,
    # n_out off the slice height, many row blocks.
    "up_c3_f32_split2": (53, 37, 90, 71, 3, "f32", "split2"),
    "wide_c3_u8_split2": (256, 120, 300, 270, 3, "u8", "split2"),
    "wide_c4_u16_split3": (64, 50, 100, 130, 4, "u16", "split3"),
    "down_c2_u16_split2": (96, 40, 50, 21, 2, "u16", "split2"),
    "tall_c1_f32_split2": (40, 300, 64, 900, 1, "f32", "split2"),
    "tall_c1_u8_split3": (33, 200, 50, 700, 1, "u8", "split3"),
    # The same edges for exact, whose kernel stores one, two or three limb
    # planes (u8, u16, f32; test_torch_unfused checks each edge): the two
    # exact cases at the top and u16 rows off and on 16 bytes, f32 rows off
    # 16 bytes, tall multi-block cases, and a 4x downsize whose slices run
    # 384 tap rows (24 16-deep steps, 144 MMAs into one accumulator).
    "up_c3_u16_exact": (53, 37, 90, 71, 3, "u16", "exact"),
    "wide_c4_u16_exact": (64, 50, 100, 130, 4, "u16", "exact"),
    "down_c3_f32_exact": (150, 97, 61, 40, 3, "f32", "exact"),
    "tall_c1_f32_exact": (40, 300, 64, 900, 1, "f32", "exact"),
    "tall_c1_u8_exact": (33, 200, 50, 700, 1, "u8", "exact"),
    "down4_c1_f32_exact": (64, 800, 16, 200, 1, "f32", "exact"),
}

# K3 (lane pass) on the card: the same fields; the pass runs over the
# image's interleaved lanes at the base tile.
LANES_CASES = {
    "up_c1_u8_split2": (53, 37, 90, 71, 1, "u8", "split2"),
    "up_c3_u8_split3": (53, 37, 90, 71, 3, "u8", "split3"),
    "up_c4_u16_split3": (53, 37, 90, 71, 4, "u16", "split3"),
    "down_c3_f32_split2": (150, 97, 61, 40, 3, "f32", "split2"),
    "down_c4_u8_split3": (150, 97, 61, 40, 4, "u8", "split3"),
    "up_c3_wide_f32_split3": (300, 20, 1400, 41, 3, "f32", "split3"),
    "up_c5_u8_split3": (53, 37, 90, 71, 5, "u8", "split3"),
    "down_c8_f32_split2": (150, 97, 61, 40, 8, "f32", "split2"),
    # The edges of the tensor-core tiling (64 image rows x one 128-lane
    # chunk a block, 32 window lanes a step, 8 lanes of a row a thread by
    # vector loads where the row pitch is 16-byte aligned; test_torch_unfused
    # checks each case has them): rows off 64 over several row blocks,
    # chunks whose nonzero range is one 32-lane step, C = 2, u8 / u16 / f32
    # rows on the vector path (the cases above read u8 and u16 rows whose
    # pitch is off 16 bytes), a wide f32 upsize, and an odd lanes_out
    # (scalar stores).
    "big_up_c1_u8_split2": (20, 70, 200, 90, 1, "u8", "split2"),
    "c2_u16_vec_split2": (64, 130, 101, 70, 2, "u16", "split2"),
    "c1_u8_vec_split3": (128, 100, 200, 60, 1, "u8", "split3"),
    "wide_c3_f32_split2": (640, 66, 1920, 99, 3, "f32", "split2"),
    "odd_out_c1_f32_split3": (33, 40, 91, 50, 1, "f32", "split3"),
}

# K4: (h, w, c, trunc_bits, out_max)
WAVEFRONT_CASES = [
    (24, 40, 1, 0, 255.0),
    (20, 33, 3, 0, 255.0),
    (17, 29, 4, 0, 255.0),
    (21, 26, 3, 0, 65535.0),
    (19, 31, 1, 0, 65535.0),
    (22, 30, 3, 2, 255.0),
    (18, 27, 4, 4, 65535.0),
    (16, 21, 5, 0, 255.0),
    (14, 19, 8, 2, 255.0),
]

# K4 at the kernel's row-group sizes: (h, w, c, trunc_bits, out_max, out
# type), each run with groups of WAVEFRONT_GROUP_WARPS warps of (row,
# channel) threads (rows per group = warps * 32 // c): H below every group
# size, H not a multiple of it, W = 1, C 1-4, trunc_bits 0 and 4, float32,
# u8 and u16 output, and images of many groups at each size.
WAVEFRONT_GROUP_CASES = {
    "h_lt_r_c1_u8": (5, 40, 1, 0, 255.0, "u8"),
    "ragged_c3_f32": (47, 33, 3, 0, 255.0, "f32"),
    "w1_c4_u16": (37, 1, 4, 0, 65535.0, "u16"),
    "c2_tb4_u16": (70, 29, 2, 4, 65535.0, "u16"),
    "c3_tb4_u8": (90, 31, 3, 4, 255.0, "u8"),
    "c4_tall_f32": (300, 24, 4, 0, 255.0, "f32"),
    "c3_tall_u8": (700, 20, 3, 0, 255.0, "u8"),
}
WAVEFRONT_GROUP_WARPS = (1, 4, 32)

# K4's exchange between lanes, warps and groups: (h, w, c, rows per group
# or None for the default), each run in both sum orders and into u8, u16
# and float32 (WAVEFRONT_WARP_OUTS).  Within a warp the row above is the
# lane C before; lanes whose row above lies in the warp before read a
# shared ring a chunk of steps at a time; rows whose channels straddle two
# warps (C = 3, 5), C that divide 32 (1, 2, 4, 8) and C above a warp (33,
# 40: every lane reads the ring, two warps read one warp's words), a
# group's last warp partial, W = 1 and W = 5 (below a chunk of 8 steps),
# H = 1, groups of one warp and of 32 (the 1024-thread
# instantiation; at C = 8 its ring needs more than 48 KB of shared memory).
WAVEFRONT_WARP_CASES = {
    "c1_two_warps": (70, 37, 1, 64),
    "c2_three_warps": (90, 29, 2, 48),
    "c3_straddle": (100, 41, 3, 20),
    "c4_three_warps": (66, 23, 4, 24),
    "c5_straddle": (80, 30, 5, 25),
    "c8_three_warps": (64, 19, 8, 12),
    "c3_partial_last_warp": (47, 33, 3, 15),
    "w1": (60, 1, 3, 21),
    "w5": (50, 5, 3, 16),
    "h1": (1, 45, 3, None),
    "h1_c8": (1, 20, 8, None),
    "one_warp": (90, 31, 3, 10),
    "warps32_c3": (700, 20, 3, 341),
    "warps32_c8": (300, 17, 8, 128),
    "warps32_c1": (1100, 9, 1, 1024),
    "c33": (10, 12, 33, 5),
    "c40": (9, 13, 40, 3),
}
# (out_max, trunc_bits) of each output type in WAVEFRONT_WARP_CASES.
WAVEFRONT_WARP_OUTS = {"u8": (255.0, 0), "u16": (65535.0, 4), "f32": (255.0, 2)}

NP_TYPES = {"u8": np.uint8, "u16": np.uint16, "f32": np.float32}
IN_BYTES = {"u8": 1, "u16": 2, "f32": 4}


def order_of(sw, sh, nw, nh):
    return "vh" if nw * nh <= sw * sh else "hv"


def split_tol(out_dtype_name, ref_max, out_max=255.0, trunc_bits=0,
              scale=1.0, gamma=False):
    """The split gate between two summation orders: float32 within
    max|ref| * 1e-4; integers within 1 LSB (one quantization step with
    ``trunc_bits``).  An integer output that amplifies the float32
    difference -- scaled up by ``scale`` > 1 (LANCIR u8 -> u16: 257), or
    through gamma-out's slope (up to 12.92) -- takes the float32 gate on
    its own range plus one rounding step (about 7.5 LSB at 16 bits; still
    1 LSB at 8 bits)."""
    if out_dtype_name == "f32":
        return ref_max * 1e-4
    if trunc_bits:
        return out_max / (int(out_max) >> trunc_bits)
    return 1.0 + (ref_max * 1e-4 if scale > 1.0 or gamma else 0.0)


def split2_tol(ops, tout, ref_max, xmax, out_max=255.0, trunc_bits=0,
               gamma=False, scale=1.0):
    """The gate of a K1 split, K7 or K8 resize (operands ``ops``; K7/K8
    carry no ``order`` and run V first) on an input of largest magnitude
    ``xmax``: the split gate, plus, for float32 output after a split2
    second pass, the flip of the intermediate's bf16 hi parts.  That pass
    multiplies bf16(v) alone, and two summation orders of the intermediate
    v can round to hi parts one bf16 ulp apart; the split3 lo part takes
    the difference up, split2 has none.  One ulp of the largest |v| (xmax
    times the first pass's largest absolute tap sum: a V row's for vh, an
    H column's for hv) times the second pass's largest absolute tap sum
    bounds the output's change.  No gamma there: the curve's slope would
    scale it.  Integer outputs keep the split gate (``scale`` and
    ``gamma`` as in split_tol)."""
    import math

    tol = split_tol(tout, ref_max, out_max, trunc_bits, scale, gamma)
    vh = getattr(ops, "order", "vh") == "vh"
    if tout != "f32" or (ops.mode_h if vh else ops.mode_v) != "split2":
        return tol
    if gamma:
        raise ValueError("the flip bound holds without gamma-out")
    vsum = float((ops.tvh.double() + ops.tvl.double()).abs().sum(-1).max())
    hsum = float((ops.thh.double() + ops.thl.double()).abs().sum(2).max())
    first, second = (vsum, hsum) if vh else (hsum, vsum)
    _, e = math.frexp(xmax * first)
    return tol + math.ldexp(1.0, e - 8) * second


def epi_kwargs(plan, round_mode, scale, gamma, alpha):
    """K1 epilogue keyword arguments of a case, the gamma multipliers
    taken from a gamma plan (either package's)."""
    kw = dict(scale=scale, round_mode=round_mode)
    if gamma:
        kw.update(
            gamma=True, alpha_index=alpha,
            in_gamma_mult=plan.in_gamma_mult,
            out_gamma_mult=plan.out_gamma_mult,
        )
    return kw


def split_source(name, sh, sw, c, tin):
    """The image [sh, sw*c] of a split case, from a seed of its name."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if tin == "f32":
        return rng.random((sh, sw * c), dtype=np.float32)
    top = 255 if tin == "u8" else 65535
    return rng.integers(0, top + 1, (sh, sw * c), dtype=NP_TYPES[tin])


def float_image(h, w, c, out_max, seed):
    """A float32 pre-dither image [h, w, c] in [0, out_max)."""
    rng = np.random.default_rng(seed)
    return (rng.random((h, w, c)) * out_max).astype(np.float32)
