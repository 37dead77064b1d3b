"""K1 split hv at each slice height on the card: the kernel built with
32, 64 and 128 output rows a block, held to its plain version and timed
in turns.

Run from the root of a checkout, on a machine with an NVIDIA card and
nvcc:  python3 split_hv_heights.py

The shipped kernel has one height (``kHvRows`` in
avir_tpu_torch/ops/cuda/csrc/fused_split.cu, ``fused_split.HV_ROWS``).
This script builds copies of that source into build/split_hv_heights/
with ``kHvRows`` set to each height (one nvcc each, all started
together), prints ptxas's registers and spills of their hv kernels, and
at chip_smoke.py's KT_SPLIT_HV_CELLS (1080p_to_4k_errdiff, the route its
resize takes; 1080p_to_4k_u16_gamma_rgba and 4k_to_8k_u16_gamma_rgba,
direct hv calls) runs each
copy through the shipped wrapper (apply_fused_split inside
fused_split.LAUNCH.through(copy)) on operands whose k_range is built at
its height.  Each is held to the plain version within the split gate
and timed with CUDA events (L2 flushed) in TURNS turns that alternate
the heights.  Prints one JSON line per cell: per height, the ms of each
turn, the largest difference from the plain version and its gate, the
MACs the MMAs issue and the image elements staged per input element.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from avir_tpu_torch.ops.cuda import build
from avir_tpu_torch.ops.cuda import fused_split as fs
from avir_tpu_torch.ops.cuda.fused_kernel import _k_ranges

HEIGHTS = (32, 64, 128)
TURNS = 5
LINE = f"constexpr int kHvRows = {fs.HV_ROWS};"
OUT = Path(__file__).resolve().parent / "build" / "split_hv_heights"


def _build() -> dict[int, ctypes.CDLL]:
    """{height: the copy's library}, ptxas's report of each in
    cs.BUILD_LOGS["r<height>"]."""
    src = (build.CSRC / build.SOURCES["fused_split"]).read_text()
    if src.count(LINE) != 1:
        raise RuntimeError(f"fused_split.cu changed: no single {LINE!r}")
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for rows in HEIGHTS:
        cu = OUT / f"fused_split_r{rows}.cu"
        cu.write_text(src.replace(LINE, f"constexpr int kHvRows = {rows};"))
        lib = OUT / f"libfused_split_r{rows}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(cu)]
        procs[rows] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for rows, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed at {rows} rows:\n{log}")
        cs.BUILD_LOGS[f"r{rows}"] = log
        libs[rows] = ctypes.CDLL(str(lib))
    return libs


def _at(ops, rows: int):
    """``ops`` with its k_range at ``rows``-row slices."""
    kr = _k_ranges((ops.tvh != 0).cpu().numpy(), (ops.tvl != 0).cpu().numpy(), rows)
    return dataclasses.replace(ops, rows=rows, k_range=torch.from_numpy(kr).to(ops.device))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    card = cs._card()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    libs = _build()
    ptxas = {rows: cs._ptxas(f"r{rows}", "fused_split_hv") for rows in HEIGHTS}
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = np.random.default_rng(cs.SEED)
    ok = True
    for cell in cs.KT_SPLIT_HV_CELLS:
        plan, hv, _, x, in_b, out_b = cs._split_hv_setup(cell, gen, dev)
        recs, tiled = {}, {}
        for rows in HEIGHTS:
            ops = _at(hv, rows)
            with fs.LAUNCH.through(libs[rows]):
                got = fs.apply_fused_split(ops, x)
            want = fs.apply_fused_split_reference(ops, x)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            tol = cs._split_gate(ops, want, float(x.double().abs().max()))
            ok = ok and err <= tol
            tiled[rows] = ops
            recs[rows] = {"ms": [], "max_abs_err_vs_plain": err, "tol": tol,
                          "blocks": int(ops.k_range[..., 0].numel() * ops.h_range[..., 0].numel()),
                          **cs._split_counts(ops)}
        for _ in range(TURNS):
            for rows, ops in tiled.items():
                with fs.LAUNCH.through(libs[rows]):
                    recs[rows]["ms"].append(
                        cs._time_ms(lambda: fs.apply_fused_split(ops, x), 20, flush))
        print(json.dumps({
            "cell": cell[0], "kernel": hv.launch_key, "mode_v": hv.mode_v,
            "mode_h": hv.mode_h, "shipped_rows": fs.HV_ROWS,
            "bound_ms": cs._split_bound(plan, cell[5], hv, in_b, out_b)[0],
            "heights": recs, "card": card,
        }))
    print(json.dumps({"ptxas": ptxas}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
