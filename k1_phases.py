"""Where K1 int8's time goes on the card: cycles a step of
fused_int8_vh_mma (default) or fused_int8_hv_mma (``--order hv``) by
phase, first-pass and second-pass steps apart.

Run from the root of a checkout, on a machine with an NVIDIA card and
nvcc:  python3 k1_phases.py [DIR] [--order vh|hv] [--stages N]

It builds a copy of DIR's avir_tpu_torch/ops/cuda/csrc/fused_int8.cu (DIR:
a checkout, this script's own by default, e.g. an older commit unpacked
into build/parent) into build/k1_phases/, in which thread 0 of every
block of the chosen kernel reads clock64 at the step's phase boundaries
and writes its sums and step counts to a device array at the end (each
block its own slots).  Each kernel's step loops are known by a text only
their source has.  vh: the ring of stages (wait for the stage's copies,
barrier, transpose the landed image tile, second barrier, MMAs, issue the
copies kStages - 1 steps ahead) and the one-step pipeline before it
(issue the next step's tap copies and image loads into registers, MMAs,
wait for the image words and transpose them, wait for the copies,
barrier).  hv: the one-tile block (a prologue that stages the lane taps,
the first image tile and V taps and waits for them; per first-pass step
the taps or conversion and their wait, the next tile's issue, the MMAs,
the requantization into the intermediate, the wait for the next tile and
a barrier; per second-pass sub-tile the next V taps' issue and wait, the
MMAs, the stores, a barrier) and the block that walks a run of tiles (the
same steps; phase 0 is each window's start, whose first copies were
issued during the window before's last sub-tile).
``--stages N`` builds the vh ring with N stages for the u8 kernel (its
shared memory grows with N).

The copy is called through DIR's own wrapper (apply_fused_int8 inside
fused_kernel.LAUNCH.through(copy), so DIR must have that launch entry),
checked bit-equal to the
shipped kernel, and both are timed with CUDA events, L2 flushed before
each launch.  vh: at the benchmark album's 5184x3456 -> 1920x1280 and at
7680x4320 -> 1920x1080, u8 RGB, AVIR's default parameters (the u8
kernel).  hv: 1920x1080 -> 3840x2160 u8 RGB with LANCIR (6 taps a row)
and with AVIR's defaults (18), the two video cells' resize.  Prints one
JSON line per shape: the mean cycles a step in each phase by step kind,
the steps (and tiles) a block, the share of a step's cycles that thread 0
spends waiting (waits and barriers), the SM clock and the two times.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

SHAPES = ((5184, 3456, 1920, 1280), (7680, 4320, 1920, 1080))
# The video cells' resize (hv).
HV_SHAPE = (1920, 1080, 3840, 2160)
SEED = 7
SLOTS = 1 << 20

# Step loops: (name, text only its source has, phases in the order they
# run, the phases that wait, edits as (old, new) with MARK(k) at the end of
# phase k).
_RING_EDITS = (
    ("      cp_wait<S - 2>();\n      __syncthreads();\n",
     "      STEP(i < nv);\n      cp_wait<S - 2>();\n      MARK(0);\n      __syncthreads();\n"
     "      MARK(1);\n"),
    ("        K::transpose(a, sm, s, lane0 + seg, n, w);\n        __syncthreads();\n",
     "        K::transpose(a, sm, s, lane0 + seg, n, w);\n        MARK(2);\n"
     "        __syncthreads();\n        MARK(3);\n"),
    ("      if (pseg < h_hi) {\n        issue(pseg, pi, s == 0 ? S - 1 : s - 1);",
     "      MARK(4);\n      if (pseg < h_hi) {\n        issue(pseg, pi, s == 0 ? S - 1 : s - 1);"),
    ("      cp_commit();\n    }\n  }\n\n  // ---- epilogue: accumulator",
     "      cp_commit();\n      MARK(5);\n    }\n  }\n\n  // ---- epilogue: accumulator"),
    ("    for (int seg = h_lo, i = 0, s = 0; seg < h_hi;",
     "    if (threadIdx.x == 0) t_ = clock64();\n    for (int seg = h_lo, i = 0, s = 0; seg < h_hi;"),
)
_REGISTER_EDITS = (
    ("    while (true) {\n      const int w = min(K::kSeg, h_hi - seg);  // a multiple of 32\n",
     "    if (threadIdx.x == 0) t_ = clock64();\n"
     "    while (true) {\n      const int w = min(K::kSeg, h_hi - seg);  // a multiple of 32\n"
     "      STEP(i < nv);\n"),
    ("      if (i < nv) {\n        // ---- first (vertical) pass step",
     "      MARK(0);\n      if (i < nv) {\n        // ---- first (vertical) pass step"),
    ("      if (more) {\n        if (ni < nv) K::store_x<IN>",
     "      MARK(1);\n      if (more) {\n        if (ni < nv) K::store_x<IN>"),
    ("      __syncthreads();\n      if (!more) break;",
     "      MARK(2);\n      __syncthreads();\n      MARK(3);\n      if (!more) break;"),
)
# The one-tile hv block (before the runs): phase 0 is a tile's prologue,
# 1-6 a first-pass step's, 7-10 a second-pass sub-tile's.
_HV_TILE_EDITS = (
    ("      cp_commit();\n      cp_wait_all();\n      __syncthreads();\n"
     "      int32_t f1[4][4] = {}, f0[4][4] = {};\n",
     "      cp_commit();\n      cp_wait_all();\n      __syncthreads();\n      MARK(0);\n"
     "      int32_t f1[4][4] = {}, f0[4][4] = {};\n"),
    ("        const int gi = s / n_mc, ci = s % n_mc;\n",
     "        STEP(true);\n        const int gi = s / n_mc, ci = s % n_mc;\n"),
    ("        if (n_mc > 1 || IN == kGamma) {\n          cp_wait_all();\n          __syncthreads();\n"
     "        }\n",
     "        if (n_mc > 1 || IN == kGamma) {\n          cp_wait_all();\n          __syncthreads();\n"
     "        }\n        MARK(1);\n"),
    ("                       min(kPiece, hw - nc * kPiece));\n          cp_commit();\n        }\n",
     "                       min(kPiece, hw - nc * kPiece));\n          cp_commit();\n        }\n"
     "        MARK(2);\n"),
    ("        if (ci == n_mc - 1) {\n", "        MARK(3);\n        if (ci == n_mc - 1) {\n"),
    ("        cp_wait_all();\n        __syncthreads();\n      }\n    }\n    // ---- phase 2",
     "        MARK(4);\n        cp_wait_all();\n        MARK(5);\n        __syncthreads();\n"
     "        MARK(6);\n      }\n    }\n    // ---- phase 2"),
    ("    for (int sub = 0; sub < kSub; ++sub) {\n",
     "    for (int sub = 0; sub < kSub; ++sub) {\n      STEP(false);\n"),
    ("      __syncthreads();\n      for (int kk = lo; kk < hi; kk += kDepth) {\n",
     "      __syncthreads();\n      MARK(7);\n      for (int kk = lo; kk < hi; kk += kDepth) {\n"),
    ("      if (win == n_win - 1) {\n        // Accumulator",
     "      MARK(8);\n      if (win == n_win - 1) {\n        // Accumulator"),
    ("      __syncthreads();\n      lo = nlo;\n",
     "      MARK(9);\n      __syncthreads();\n      MARK(10);\n      lo = nlo;\n"),
)
# The hv block that walks a run of tiles: as the one-tile block's marks,
# phase 0 now each window's start (its tile's fields, the wait for its
# first copies, issued a sub-tile before, and a barrier); phase 7 issues
# the next sub-tile's V taps or the next window's first copies.
_HV_RUNS_EDITS = (
    ("      // The window's first copies (issued a sub-tile before) landed.\n"
     "      cp_wait_all();\n      __syncthreads();\n",
     "      // The window's first copies (issued a sub-tile before) landed.\n"
     "      cp_wait_all();\n      __syncthreads();\n      MARK(0);\n"),
    ("        const int gi = n_mc == 1 ? s : s / n_mc, ci = s - gi * n_mc;\n",
     "        STEP(true);\n        const int gi = n_mc == 1 ? s : s / n_mc, ci = s - gi * n_mc;\n"),
    ("        if (n_mc > 1 || IN == kGamma) {\n          cp_wait_all();\n          __syncthreads();\n"
     "        }\n",
     "        if (n_mc > 1 || IN == kGamma) {\n          cp_wait_all();\n          __syncthreads();\n"
     "        }\n        MARK(1);\n"),
    ("                       min(kPiece, T.hw - nc * kPiece));\n          cp_commit();\n        }\n",
     "                       min(kPiece, T.hw - nc * kPiece));\n          cp_commit();\n        }\n"
     "        MARK(2);\n"),
    ("        if (ci == n_mc - 1) {\n", "        MARK(3);\n        if (ci == n_mc - 1) {\n"),
    ("        cp_wait_all();\n        __syncthreads();\n      }\n      if (n_mc > 1) t_chunk = -1;",
     "        MARK(4);\n        cp_wait_all();\n        MARK(5);\n        __syncthreads();\n"
     "        MARK(6);\n      }\n      if (n_mc > 1) t_chunk = -1;"),
    ("    for (int sub = 0; sub < kSub; ++sub) {\n      int nlo = 0, nhi = 0;\n",
     "    for (int sub = 0; sub < kSub; ++sub) {\n      STEP(false);\n      int nlo = 0, nhi = 0;\n"),
    ("      __syncthreads();\n      int32_t pa_s[4][4] = {}, pb_s[4][4] = {};",
     "      __syncthreads();\n      MARK(7);\n      int32_t pa_s[4][4] = {}, pb_s[4][4] = {};"),
    ("      if (kCarry && win == n_win - 1) {\n",
     "      MARK(8);\n      if (kCarry && win == n_win - 1) {\n"),
    ("      __syncthreads();\n      vbuf ^= 1;\n",
     "      MARK(9);\n      __syncthreads();\n      MARK(10);\n      vbuf ^= 1;\n"),
)
# Step loops of each kernel: (name, text only its source has, phases in
# the order they run, the phases that wait, edits as (old, new) with
# MARK(k) at the end of phase k, the text that ends the kernel).
LOOPS = {
    "vh": (
        ("ring", "cp_wait<S - 2>();",
         ("wait for the stage", "barrier", "transpose", "second barrier", "MMAs",
          "issue the step kStages - 1 ahead"),
         ("wait for the stage", "barrier", "second barrier"), _RING_EDITS,
         "pa[c][2 * h + e], pb[c][2 * h + e]);\n      }\n    }\n  }\n}"),
        ("registers", "K::load_x<IN>(a, row0 + ni * K::kStep",
         ("issue the next step", "MMAs", "image words landed and transposed, copies waited",
          "barrier"),
         ("image words landed and transposed, copies waited", "barrier"), _REGISTER_EDITS,
         "pa[c][2 * h + e], pb[c][2 * h + e]);\n      }\n    }\n  }\n}"),
    ),
    "hv": (
        ("tile", "K::stage_img(a, sm, 0, row0 + w0, lane0, min(kPiece, hw));",
         ("prologue: taps, first tile and V staged, waited", "taps or conversion, waited",
          "issue the next image tile", "MMAs", "requantize into XT", "wait for the next tile",
          "barrier", "issue the next V taps, wait, barrier", "second-pass MMAs",
          "epilogue stores", "end barrier"),
         ("prologue: taps, first tile and V staged, waited", "taps or conversion, waited",
          "wait for the next tile", "barrier", "issue the next V taps, wait, barrier",
          "end barrier"), _HV_TILE_EDITS,
         "      lo = nlo;\n      hi = nhi;\n    }\n  }\n}"),
        ("runs", "const auto prefetch = [&](int f, int win, int vbuf) {",
         ("window start: its tile, wait for its first copies, barrier",
          "taps or conversion, waited", "issue the next image tile", "MMAs",
          "requantize into XT", "wait for the next tile", "barrier",
          "issue the next V taps or window's copies, wait, barrier", "second-pass MMAs",
          "epilogue stores", "end barrier"),
         ("window start: its tile, wait for its first copies, barrier",
          "taps or conversion, waited", "wait for the next tile", "barrier",
          "issue the next V taps or window's copies, wait, barrier", "end barrier"),
         _HV_RUNS_EDITS, "    f = nf;\n    win = nwin;\n  }\n}"),
    ),
}


def _timed_source(src: str, stages: int | None, order: str = "vh") -> tuple[str, tuple, tuple]:
    """fused_int8.cu with the phase marks in the ``order`` kernel; the
    loop's name, its phase names and the names of the phases that wait."""
    name, tell, phases, waits, edits, end = next(lp for lp in LOOPS[order] if lp[1] in src)
    n = len(phases)
    head = (
        f"__device__ unsigned long long g_phases[{SLOTS}];\n"
        "#define MARK(k) do { if (threadIdx.x == 0) { const unsigned long long n_ = "
        "clock64(); acc_[kind_][k] += n_ - t_; t_ = n_; } } while (0)\n"
        "#define STEP(first) do { kind_ = (first) ? 0 : 1; cnt_[kind_] += 1; } while (0)\n"
    )
    slots = 2 * n + 3
    edits = (
        *edits,
        ("namespace {\n\nusing namespace mma_s8;", head + "namespace {\n\nusing namespace mma_s8;"),
        (f"fused_int8_{order}_mma(const Args a) {{\n",
         f"fused_int8_{order}_mma(const Args a) {{\n"
         f"  unsigned long long t0_ = clock64(), t_ = t0_, acc_[2][{n}] = {{}}, cnt_[2] = {{}};\n"
         "  int kind_ = 0;\n"),
        (end,
         end[:-1] +
         "  if (threadIdx.x == 0) {\n"
         f"    unsigned long long* o = g_phases + (blockIdx.y * gridDim.x + blockIdx.x) * {slots};\n"
         f"    for (int k = 0; k < {n}; ++k) {{ o[k] = acc_[0][k]; o[{n} + k] = acc_[1][k]; }}\n"
         f"    o[{2 * n}] = cnt_[0];\n    o[{2 * n + 1}] = cnt_[1];\n"
         f"    o[{2 * n + 2}] = clock64() - t0_;\n"
         "  }\n}"),
    )
    if stages is not None:
        if name != "ring" or order != "vh":
            raise RuntimeError("--stages needs the vh ring's source")
        edits += (("  static constexpr int kStages = 4;",
                   f"  static constexpr int kStages = IN == kU8 ? {stages} : 4;"),)
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"fused_int8.cu changed: no single {old!r}")
        src = src.replace(old, new)
    return src + (
        '\nextern "C" int k1_phases_read(void* host, int n) {\n'
        "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_phases, n * sizeof(unsigned long long)));\n"
        "}\n"
    ), (name, phases, waits)


def _build(root: str, out_root: str, stages: int | None, order: str):
    from avir_tpu_torch.ops.cuda import build

    csrc = os.path.join(root, "avir_tpu_torch", "ops", "cuda", "csrc")
    with open(os.path.join(csrc, "fused_int8.cu")) as f:
        text, loop = _timed_source(f.read(), stages, order)
    tag = f"{hashlib.sha256(os.path.abspath(root).encode()).hexdigest()[:12]}_{order}_{stages or 0}"
    out = os.path.join(out_root, "build", "k1_phases", tag)
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "fused_int8_phases.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(out, "libfused_int8_phases.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib), loop


def _executors(order: str):
    """(name, executor factory, plan) of each shape the ``order`` kernel is
    timed at."""
    from avir_tpu_torch.models.runtime import make_avir_executor, make_lancir_executor
    from avir_tpu_torch.plan.lancir_plan import build_lancir_plan
    from avir_tpu_torch.plan.plan import build_resize_plan

    if order == "vh":
        return [(f"{sw}x{sh}->{nw}x{nh}", make_avir_executor,
                 build_resize_plan(sw, sh, nw, nh, 3, np.uint8, np.uint8))
                for sw, sh, nw, nh in SHAPES]
    sw, sh, nw, nh = HV_SHAPE
    return [
        (f"lancir {sw}x{sh}->{nw}x{nh}", make_lancir_executor,
         build_lancir_plan(sw, sh, nw, nh, 3, np.uint8, np.uint8)),
        (f"avir {sw}x{sh}->{nw}x{nh}", make_avir_executor,
         build_resize_plan(sw, sh, nw, nh, 3, np.uint8, np.uint8)),
    ]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("root", nargs="?", default=None,
                   help="checkout whose kernel is timed (default: this script's)")
    p.add_argument("--order", choices=("vh", "hv"), default="vh",
                   help="the kernel whose steps are marked")
    p.add_argument("--stages", type=int, default=None,
                   help="the u8 vh kernel's ring stages in the timed copy")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(args.root or here)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from avir_tpu_torch.ops.cuda import fused_kernel as fk

    lib, (loop, phases, waits) = _build(root, here, args.stages, args.order)
    lib.k1_phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda")
    gen = np.random.default_rng(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    n = len(phases)
    for shape, make, plan in _executors(args.order):
        fn = make(plan, device=dev)
        ops = fn.ops
        if fn.route != "int8" or ops.order != args.order or ops.epi.gamma:
            raise RuntimeError(f"{shape}: not the u8 {args.order} kernel ({fn.route}, {ops.order})")
        x = torch.from_numpy(
            gen.integers(0, 256, (plan.src_h, plan.src_w * 3), dtype=np.uint8)).to(dev)
        tiles = ops.h_range.shape[0] * ops.h_range.shape[1] * ops.slice_range.shape[0] \
            * ops.slice_range.shape[1]
        # The hv launch walks runs of tiles (ops.blocks of them).
        blocks = getattr(ops, "blocks", 0) or tiles
        if blocks * (2 * n + 3) > SLOTS:
            raise RuntimeError("too many blocks for the phase array")

        def run_shipped():
            return fk.apply_fused_int8(ops, x)

        def run_timed():
            with fk.LAUNCH.through(lib):
                return fk.apply_fused_int8(ops, x)

        want = run_shipped()
        got = run_timed()
        torch.cuda.synchronize()
        bit_equal = bool(torch.equal(got, want))
        sums = np.zeros(blocks * (2 * n + 3), dtype=np.uint64)
        if lib.k1_phases_read(sums.ctypes.data, sums.size):
            raise RuntimeError("reading the phase sums failed")
        per = sums.reshape(blocks, 2 * n + 3).astype(np.float64)
        work = per[:, 2 * n] + per[:, 2 * n + 1] > 0
        cycles, share, steps = {}, {}, {}
        extra = {}
        if args.order == "hv":
            # Phase 0 is a window's start (the one-tile block: its
            # prologue), whichever step kind it follows.
            extra["prologue_cycles_a_block"] = float(
                (per[work, 0] + per[work, n]).sum() / work.sum())
            extra["prologue_cycles_a_tile"] = float(
                (per[work, 0] + per[work, n]).sum() / tiles)
            extra["tiles_a_block"] = tiles / blocks
            per[:, 0] = per[:, n] = 0.0
        for kind, label in ((0, "first_pass"), (1, "second_pass")):
            count = per[work, 2 * n + kind].sum()
            tot = per[work, kind * n:(kind + 1) * n].sum(axis=0)
            steps[label] = float(count / work.sum())
            cycles[label] = {name: float(tot[k] / count) for k, name in enumerate(phases)
                             if tot[k] > 0 or (kind == 0 and args.order == "vh")}
            share[label] = float(sum(tot[k] for k, name in enumerate(phases) if name in waits)
                                 / tot.sum())
        if args.order == "hv":
            # Both kinds together.
            count = per[work, 2 * n:2 * n + 2].sum()
            tot = per[work, :n].sum(axis=0) + per[work, n:2 * n].sum(axis=0)
            cycles["all_steps"] = {name: float(tot[k] / count) for k, name in enumerate(phases)
                                   if tot[k] > 0}
            share["all_steps"] = float(sum(tot[k] for k, name in enumerate(phases)
                                           if name in waits) / tot.sum())
        print(json.dumps({
            "shape": shape, "order": args.order, "loop": loop,
            "stages": args.stages,
            "root": root, "launch_key": ops.launch_key, "rows": ops.rows,
            "bit_equal_to_kernel": bit_equal, "blocks": int(blocks),
            "blocks_with_work": int(work.sum()), "steps_a_block": steps, **extra,
            "cycles_a_step": cycles, "wait_share": share,
            "cycles_a_block": float(per[work, 2 * n + 2].mean()),
            "cycles_a_block_max": float(per[work, 2 * n + 2].max()),
            "sm_clock": clock,
            "kernel_ms": cs._time_ms(run_shipped, 20, flush),
            "timed_copy_ms": cs._time_ms(run_timed, 20, flush),
            "card": cs._card(),
        }), flush=True)
        if not bit_equal:
            print("timed copy differs from the kernel", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
