"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. prints the card's name and power limit (nvidia-smi), builds every
     CUDA kernel from the sources in the checkout (one nvcc per source,
     all started together) and prints the build time;
  2. holds each kernel against its plain PyTorch version on the card, on
     small cases covering both pass orders, C in {1, 3, 4}, chunked and
     unchunked lane forms and ragged edges: bit-equal;
  3. drives the main path through ``avir_tpu_torch.ImageResizer.resize``
     at 7680x4320 -> 1920x1080 and 1920x1080 -> 3840x2160 u8 RGB, with
     the launch counts set to 0 just before each first call and read
     just after; each output must be bit-equal to the plain version and
     within 1 LSB / >= 60 dB of the float64 host oracle;
  4. times each kernel at its main-path shape with CUDA events (L2
     flushed before every launch) beside its bound and its plain
     version's time, plus the host wall time of a cached resize and its
     two copies, and prints one JSON line per shape;
  5. prints the kernels line and, last, the device line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data sheet (700 W): HBM rate and dense int8 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
SEED = 7
MAIN_PATH = (
    # (name, src_w, src_h, new_w, new_h, c)
    ("8k_to_1080p", 7680, 4320, 1920, 1080, 3),
    ("1080p_to_4k", 1920, 1080, 3840, 2160, 3),
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
)
KERNELS = {
    "fused_int8_vh": "avir_tpu/ops/pallas/fused_kernel.py:191 (_int8_passes, "
    "order vh; entry apply_fused_pallas :422)",
    "fused_int8_hv": "avir_tpu/ops/pallas/fused_kernel.py:268 (_int8_passes, "
    "order hv; entry apply_fused_pallas :422)",
}
SOURCE = "avir_tpu_torch/ops/cuda/csrc/fused_int8.cu"


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def _oracle(plan, src: np.ndarray) -> np.ndarray:
    """Float64 host oracle: both banded operators applied with
    apply_banded_numpy, in slabs to bound host memory."""
    from avir_tpu_torch.plan.compose import apply_banded_numpy

    h, w, c = src.shape
    x = np.moveaxis(src, 1, 0).reshape(w, h * c)
    step = max(1, (1 << 27) // (plan.h.op.n_out * plan.h.op.width * 8))
    hx = np.concatenate(
        [apply_banded_numpy(plan.h.op, x[:, i : i + step])
         for i in range(0, h * c, step)],
        axis=1,
    )  # [new_w, h*c]
    x = np.moveaxis(hx.reshape(-1, h, c), 1, 0).reshape(h, -1)
    step = max(1, (1 << 27) // (plan.v.op.n_out * plan.v.op.width * 8))
    vx = np.concatenate(
        [apply_banded_numpy(plan.v.op, x[:, i : i + step])
         for i in range(0, x.shape[1], step)],
        axis=1,
    )
    out = np.clip(np.floor(vx + 0.5), 0, 255).astype(np.uint8)
    return out.reshape(plan.v.op.n_out, plan.h.op.n_out, c)


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


def _bound(plan, c: int, order: str) -> tuple[float, str, int, int]:
    """(bound_ms, bound_by, bytes, ops): image bytes read once and
    written once plus the two banded operators as two s8 limbs per tap;
    band MACs (two products in the first pass, three in the second)."""
    h, v = plan.h.op, plan.v.op
    lanes_in, lanes_out = h.n_in * c, h.n_out * c
    nbytes = (
        v.n_in * lanes_in + v.n_out * lanes_out
        + 2 * (h.n_out * h.width + v.n_out * v.width)
    )
    if order == "vh":
        macs = v.n_out * lanes_in * v.width * 2 + v.n_out * lanes_out * h.width * 3
    else:
        macs = v.n_in * lanes_out * h.width * 2 + v.n_out * lanes_out * v.width * 3
    ops = 2 * macs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return (
        1e3 * max(t_bytes, t_ops),
        "bytes" if t_bytes >= t_ops else "operations",
        nbytes,
        ops,
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2

    import avir_tpu_torch
    from avir_tpu_torch.models.runtime import make_avir_executor
    from avir_tpu_torch.ops.banded import block_banded
    from avir_tpu_torch.ops.cuda import build
    from avir_tpu_torch.ops.cuda import fused_kernel as fk
    from avir_tpu_torch.ops.lanes import lane_block_banded
    from avir_tpu_torch.plan.plan import build_resize_plan

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}"
    )

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    report = build.build()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "built": sorted(report)}))
    for name, info in report.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", file=sys.stderr)

    dev = torch.device("cuda")
    gen = np.random.default_rng(SEED)

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
        got = fk.apply_fused_int8(ops, x)
        torch.cuda.synchronize()
        want = fk.apply_fused_int8_reference(ops, x)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        case = f"{sw}x{sh}->{nw}x{nh} C={c} tile={tile} {order}"
        print(json.dumps({"case": case, "max_abs_err": err}))
        if err != 0:
            _fail(f"kernel != plain on {case}")

    # ---- 3./4. main path, checks and timing ----------------------------
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    entries = []
    for name, sw, sh, nw, nh, c in MAIN_PATH:
        src = gen.integers(0, 256, (sh, sw, c), dtype=np.uint8)
        order = "vh" if nw * nh <= sw * sh else "hv"
        kname = f"fused_int8_{order}"

        resizer = avir_tpu_torch.ImageResizer()
        for k in fk.launches:
            fk.launches[k] = 0
        t0 = time.perf_counter()
        out = resizer.resize(src, nw, nh)
        first_s = time.perf_counter() - t0
        counts = dict(fk.launches)
        print(json.dumps({"main_path": name, "launches": counts}))
        if counts[kname] < 1:
            _fail(f"{name}: {kname} was not launched on the main path")
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
        print(json.dumps({
            "shape": name, "kernel": kname, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "int8_ops": nops, "max_abs_err_vs_plain": err,
            "max_lsb_vs_f64_oracle": lsb, "psnr_vs_f64_oracle_db": psnr,
            "first_pass_reads_per_input": _first_pass_reads(ops),
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
        entries.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": KERNELS[kname], "launches": counts[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })

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
